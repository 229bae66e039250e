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
               loss and tokens) takes 2 warm-up and 8 timed steps: losses
               finite and falling, masters fp32, and each step ran
               flash_fwd, flash_dq and flash_dkv once per layer; (iii)
               step ms, tokens/s, MFU, peak memory and a profile; (iv)
               the default fp32 step (compute_dtype=None) at the same
               width, batch, optimizer, loss and tokens, from the same
               seeded weights, once (ii)'s step and its Adam state are
               freed: 2 warm-up and 3 timed steps, losses finite and
               falling, each step one launch of flash_fwd, flash_dq and
               flash_dkv per layer; step ms, tokens/s, peak memory and a
               profiled step's device ms by class (flash_dq and
               flash_dkv apart).
8. resnet      bench.py's headline workload on the port's Gluon path, no
               hand kernel on it: (i) resnet50_v1() from seed 0 on the
               card and on the CPU (load_gluon_params), fp32 with TF32
               off, one ShardedTrainStep SGD step at B=2 x 3x224x224:
               losses within 1e-4 rel, gradients within 1e-2 (median
               3e-3; the CPU's own floor printed), BatchNorm moving
               stats within 1e-4; (ii) bench.py's step: functionalize,
               ShardedTrainStep(sgd, lr 0.1, momentum 0.9, wd 1e-4,
               bf16 over fp32 masters) at B=32 on bench.py's batch, 3
               warm-up and 20 timed steps, losses finite and falling;
               img/s, step ms, peak memory, MFU against 989 TFLOP/s
               from the port's own count of train FLOPs per image
               (convolution and dense shapes, within 2% of bench.py's
               3 x 7.826e9), one profiled step's device ms by class
               (conv, batchnorm, pool, matmul, optimizer, other) and
               busy share; (iii) the same step in fp32; (iv) 23 steps
               of the imperative loop (autograd.record, SoftmaxCross
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
(``device_ms_traces``, printed with ``phase_seconds``).  ``call_ms`` is
the time of one call between two CUDA events, which also counts the
host's work before the launch.
"""
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


def device_ms(fn, torch, what, warmup=3, reps=20):
    """Device time of one call of ``what``: the summed device time of
    the kernels (and copies) of ``reps`` back-to-back calls under
    torch.profiler, over ``reps``.  Host time and the gaps between
    launches drop out.  A trace that holds no device event at all (seen
    on the card for calls that launched kernels) is taken again, up to
    TRACE_ATTEMPTS traces, and counted in TRACES["empty"], which the run
    prints; if none has device time the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(warmup):
        fn()
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        TRACES["taken"] += 1
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
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
    time (the profiler's own host cost makes it a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    try:
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): an operator's row
        # on the host repeats its kernels' time
        rows = sorted(((e.key, e.self_device_time_total / 1e3)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
    except RuntimeError as exc:   # a measurement, not a check
        return {"error": str(exc)}
    busy = sum(ms for _, ms in rows)
    by_class = {}
    for key, ms in rows:
        cls = kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    return {"wall_ms": wall, "device_ms": busy,
            "device_busy_share": busy / wall if rows else None,
            "device_ms_by_class": by_class,
            "top_ms": [[k[:60], ms] for k, ms in rows[:6]]}


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


def phase_train(mt, torch, net, card):
    import numpy as np

    launches = mt.ops.LAUNCHES
    cpu_check = train_check_cpu(mt, torch, net)
    b, l = TRAIN
    vocab = MODEL["vocab_size"]
    step = mt.parallel.ShardedTrainStep(
        net, optimizer="adam", optimizer_params=dict(learning_rate=1e-4),
        loss_fn=lm_loss, compute_dtype=torch.bfloat16)
    rs = np.random.RandomState(0)       # bench.py's tokens and labels
    toks = torch.from_numpy(
        rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()
    labels = torch.from_numpy(
        rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()
    counts = {k: [] for k in TRAIN_KERNELS}

    def one_step():
        mt.ops.reset_launches()
        loss = step(toks, labels)               # the main path
        for k in TRAIN_KERNELS:
            counts[k].append(launches[k])
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [one_step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    losses += [one_step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    layers = MODEL["n_layers"]
    for k, n in counts.items():
        check(all(c == layers for c in n),
              f"train steps launched {k} {n} times, not {layers} each")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "masters are not fp32")
    prof = profile(lambda: step(toks, labels), torch)
    tok_s = b * l / step_ms * 1e3
    flops_tok = net.train_flops_per_token(l)
    del step                    # and its Adam state, before step (iv)
    torch.cuda.empty_cache()
    fp32, fp32_counts = fp32_train(mt, torch, net, toks, labels)
    emit({"phase": "train", "card": card, "cpu_check": cpu_check,
          "batch": b, "seq": l, "optimizer": "adam", "lr": 1e-4,
          "compute_dtype": "bfloat16", "warmup_steps": WARMUP_STEPS,
          "timed_steps": TIMED_STEPS, "losses": losses,
          "warmup_ms": warm_ms, "step_ms": step_ms,
          "tokens_per_s": tok_s, "train_flops_per_token": flops_tok,
          "mfu": flops_tok * tok_s / H100_BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s bf16 dense",
          "peak_memory_bytes": peak, "launches_per_step": counts,
          "profile": prof, "fp32_step": fp32})
    return counts, fp32_counts


def fp32_train(mt, torch, net, toks, labels):
    """(iv) the default ShardedTrainStep, fp32 (compute_dtype=None), at
    bench.py's width and batch with step (ii)'s optimizer, loss and
    tokens: the path that runs the fp32 flash_dq and flash_dkv once per
    layer a step.  It starts where (ii) started, from the seeded weights
    and a fresh Adam state (a fresh Adam on weights that (ii) has moved
    first steps every parameter by lr and raises the loss).  Returns
    its record and the launches of each step."""
    launches = mt.ops.LAUNCHES
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(SEED))
    step = mt.parallel.ShardedTrainStep(
        net, optimizer="adam", optimizer_params=dict(learning_rate=1e-4),
        loss_fn=lm_loss)
    counts = {k: [] for k in TRAIN_KERNELS}

    def one_step():
        mt.ops.reset_launches()
        loss = step(toks, labels)               # the main path
        for k in TRAIN_KERNELS:
            counts[k].append(launches[k])
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [one_step() for _ in range(FP32_WARMUP_STEPS)]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    losses += [one_step() for _ in range(FP32_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / FP32_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    layers = MODEL["n_layers"]
    for k, n in counts.items():
        check(all(c == layers for c in n),
              f"fp32 train steps launched {k} {n} times, not {layers} "
              f"each")
    check(all(math.isfinite(x) for x in losses), f"fp32 losses {losses}")
    check(losses[-1] < losses[0], f"fp32 loss did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "parameters are not fp32")
    prof = profile(lambda: step(toks, labels), torch)
    b, l = toks.shape
    return {"compute_dtype": "float32", "warmup_steps": FP32_WARMUP_STEPS,
            "timed_steps": FP32_TIMED_STEPS, "losses": losses,
            "warmup_ms": warm_ms, "step_ms": step_ms,
            "tokens_per_s": b * l / step_ms * 1e3,
            "peak_memory_bytes": peak, "launches_per_step": counts,
            "profile": prof}, counts


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

    def rel_errs(got, ref):
        return {n: (got[n].cpu() - r).norm().item() / r.norm().item()
                for n, r in ref.items() if r.norm().item() > 0}

    def summary(errs):
        vals = sorted(errs.values())
        worst = max(errs, key=errs.get)
        return {"median": vals[len(vals) // 2], "worst": errs[worst],
                "worst_param": worst}

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
    tol = {"worst": max(1e-2, 3 * floor["worst"]),
           "median": max(3e-3, 3 * floor["median"])}
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


def resnet_step_profile(torch, step, x, y):
    """One profiled step's device ms by class (conv, batchnorm, pool,
    matmul, optimizer, other) and the busy share.  The optimizer's
    elementwise kernels carry no telling name, so its update is timed
    alone (on zero gradients: the same kernels) and moved out of
    "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by, rows = {}, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            ms = e.self_device_time_total / 1e3
            cls = resnet_class(e.key)
            by[cls] = by.get(cls, 0.0) + ms
            rows.append((ms, cls, e.key[:70]))
    busy = sum(by.values())
    zeros = {n: torch.zeros_like(p) for n, p in step.params.items()}
    opt_ms = device_ms(lambda: step.opt.update(step.params, zeros,
                                               step.opt_state),
                       torch, "the SGD update", warmup=1, reps=3)
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


def phase_resnet(mt, torch, card):
    launches = mt.ops.LAUNCHES
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cpu_check = resnet_check_cpu(mt, torch)
    x, y = resnet_batch(torch)
    net = resnet_net(mt, torch, "cuda")
    flops_img = resnet_train_flops(mt, torch, net)
    drift = abs(flops_img - RESNET_FLOPS_PER_IMG) / RESNET_FLOPS_PER_IMG
    check(drift <= 0.02, f"train FLOPs per image {flops_img} is "
                         f"{drift:.3%} from bench.py's 3 x 7.826e9")
    pure = mt.parallel.functionalize(net)
    step = mt.parallel.ShardedTrainStep(pure, "sgd", RESNET_SGD,
                                        compute_dtype=torch.bfloat16)
    mt.ops.reset_launches()
    bf16 = resnet_timed_steps(torch, step, x, y, RESNET_WARMUP,
                              RESNET_TIMED)           # the main path
    n = dict(launches)
    check(all(p.dtype == torch.float32 for p in step.params.values()),
          "masters are not fp32")
    bf16["profile"] = resnet_step_profile(torch, step, x, y)
    bf16["host_profile"] = host_profile(lambda: step(x, y), torch,
                                        calls=1, top=12)
    bf16["mfu"] = flops_img * bf16["images_per_s"] / H100_BF16_FLOPS
    del step, pure, net
    torch.cuda.empty_cache()
    net = resnet_net(mt, torch, "cuda")
    step = mt.parallel.ShardedTrainStep(net, "sgd", RESNET_SGD)
    fp32 = resnet_timed_steps(torch, step, x, y, RESNET_WARMUP,
                              RESNET_TIMED)
    del step, net
    torch.cuda.empty_cache()
    loop = resnet_loop(mt, torch, x, y)
    emit({"phase": "resnet", "card": card, "model": "resnet50_v1",
          "batch": RESNET_BATCH, "image": list(RESNET_IMAGE),
          "optimizer": "sgd", **RESNET_SGD, "tf32": tf32,
          "cpu_check": cpu_check, "train_flops_per_image": flops_img,
          "flops_drift_vs_bench": drift, "mfu_peak":
          "989 TFLOP/s bf16 dense", "warmup_steps": RESNET_WARMUP,
          "timed_steps": RESNET_TIMED, "bf16_step": bf16,
          "fp32_step": fp32, "gluon_loop": loop,
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
    return {"build_seconds": build_s, "ptxas": ptxas, "cases": rows,
            "scale_edges": edges, "scale_turns": turns}, entries


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
        train_launches, fp32_launches = timed("train", phase_train, mt,
                                              torch, net, card)
        del net
        resnet_launches = timed("resnet", phase_resnet, mt, torch, card)
        rtc_entries, nd_flash = timed("rtc", phase_rtc, mt, torch)
        emit({"phase_seconds": seconds, "device_ms_traces": TRACES})
        entry["launches_by_path"] = {"forward": fwd_launches,
                                     "serve": serve_launches,
                                     "serve_engine":
                                         engine_launches["flash_fwd"],
                                     "train": train_launches["flash_fwd"],
                                     "fp32_train": fp32_launches["flash_fwd"],
                                     "nd": nd_flash}
        for e in bwd_entries:
            e["launches_by_path"] = {
                "serve_engine": engine_launches[e["name"]],
                "train": train_launches[e["name"]],
                "fp32_train": fp32_launches[e["name"]]}
            e["fp32_train"]["launches"] = sum(fp32_launches[e["name"]])
        for e in [entry] + bwd_entries + rtc_entries:
            e["launches_by_path"]["resnet"] = resnet_launches.get(
                e["name"], 0)
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
