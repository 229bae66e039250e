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
               wgmma serialized by ptxas.
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
7. train       (i) one fp32 loss and every parameter's gradient at B=1 x
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
8. resnet      bench.py's headline workload on the port's Gluon path, no
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
               EntropyLoss, backward, gluon.Trainer.step(32)): losses
               finite and falling, every parameter with a gradient.
               (The loss rises for steps 3 to 7 at lr 0.1 before it
               falls, so each run takes 23 steps.)  Each
               kernel's launches on this path are counted ("resnet").
9. rtc         the user-kernel path (rtc_examples.py): builds the four
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

10. module     the symbolic frontend: (i) the MNIST MLP through
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
11. hybridize  HybridBlock.hybridize() through graph.CachedOp: (i)
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
12. moe        TransformerLM at bench.py's width with moe_experts=8
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
13. ops        the samplers, ordering and linear algebra (no hand
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
14. rnn        the recurrent stack (cuDNN's RNN, no hand kernel): (i)
               the fused RNN op for each mode, one way and
               bidirectional, at the word LM's width (2 layers of 1500,
               T=35, N=20): outputs within 1e-4 and gradients within
               1e-3 (max error over max) of the CPU on the same
               weights; (ii) the Gluon word LM (examples/
               word_language_model.py's RNNModel, untied, with dropout)
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

Then it prints the card's name and power limit (nvidia-smi), the kernel
table ({"kernels": [...]}; ``launches`` is the sum over the main paths'
runs, ``launches_by_path`` each run's own count) and, last,
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
    for _ in range(warmup):
        fn()
    for _ in range(TRACE_ATTEMPTS):
        with device_trace(torch) as prof:
            for _ in range(reps):
                fn()
        TRACES["taken"] += 1
        us = sum(e.self_device_time_total for e in device_events(prof))
        if us > 0:
            return us / 1e3 / reps
        TRACES["empty"] += 1
    raise CheckFailed(f"torch.profiler recorded no device time for "
                      f"{what} in {TRACE_ATTEMPTS} traces")


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
    backward, Trainer.step(32), from fresh seeded weights."""
    net = resnet_net(mt, torch, "cuda")
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", RESNET_SGD)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mt.nd.NDArray(x), mt.nd.NDArray(y)
    losses, step_ms = [], []
    for _ in range(RESNET_LOOP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(RESNET_BATCH)
        losses.append(float(loss.mean().asscalar()))      # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(v) for v in losses), f"loop losses {losses}")
    check(losses[-1] < losses[0], f"loop loss did not fall: {losses}")
    no_grad = [p.name for p in net.collect_params().values()
               if p.grad_req != "null"
               and not bool((p.grad().handle != 0).any())]
    check(not no_grad, f"loop left parameters without a gradient: "
                       f"{no_grad[:5]}")
    return {"steps": RESNET_LOOP_STEPS, "losses": losses,
            "step_ms": step_ms, "step_ms_after_first":
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
    """examples/word_language_model.py's RNNModel, untied, with
    dropout on the embedding, between the LSTM layers and on its output
    (the reference Gluon example's and Zaremba et al.'s placement)."""
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
                self.decoder = mt.gluon.nn.Dense(vocab, flatten=False,
                                                 in_units=nhid)

        def forward(self, x, state):
            emb = self.drop(self.encoder(x))
            out, state = self.rnn(emb, state)
            return self.decoder(self.drop(out)), state

    net = RNNModel(wl["vocab"], wl["emsize"], wl["nhid"], wl["nlayers"])
    mt.random.seed(SEED)
    net.initialize(mt.initializer.Xavier(), ctx=device)
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
        for e in [entry] + bwd_entries + rtc_entries:
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
            if e["name"] in hyb_runs:
                e["runs_per_replay"] = {"hybridize": hyb_runs[e["name"]]}
            e["launches"] = sum(
                n if isinstance(n, int) else sum(n)
                for n in e["launches_by_path"].values())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(card)
    emit({"kernels": [entry] + bwd_entries + rtc_entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
