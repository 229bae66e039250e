#!/usr/bin/env python3
"""Hold this tree's flash backward and fp32 train step against another
checkout's on one NVIDIA card, in turns.

    python3 incubator_mxnet_tpu_torch/tools/compare_bwd.py --parent DIR \\
        [--variant NAME=B32,B64,B128 ...]

DIR is the root of another checkout of the repository (for instance
``git archive <commit> | tar -x -C DIR``).  Two parts, each printing
JSON lines:

1. Kernels.  Builds with nvcc ``csrc/flash_bwd.cu`` of this tree
   ("change"), of DIR ("parent") and of each variant: this tree's source
   with the fp32 kernels' streamed rows a tile (``BN`` of ``Tf32Dq`` and
   ``Tf32Dkv``) set to B32, B64 and B128 at head dims 32, 64 and 128.
   Prints each build's ptxas registers, spills and wgmma warnings.  On
   every fp32 case of chip_smoke.py's kernels_bwd phase it holds each
   build within 1e-4 (abs + rel) of the plain backward, checks that a
   second launch gives the same bits, and times flash_dq and flash_dkv
   on the device's clock (chip_smoke's ``device_ms``) for each build in
   turn, then again in reverse order.
2. Step.  chip_smoke.py's fp32 train step (iv) and the rtc ``scale``
   kernel against ``torch.mul`` at (8192, 4096), three times each, in a
   process of its own for each of DIR, this tree, this tree and DIR.

Builds go under ``--out`` (default ``build/compare_bwd``, git-ignored).
Exits non-zero without a CUDA card, or if a check fails.
"""
import argparse
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BN_LINE = "static constexpr int BN = D == 32 ? 32 : 16;"


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_libs(parent, variants, out):
    """{name: (library path, nvcc's log)} for this tree, the parent and
    each variant, one nvcc each, all together."""
    from incubator_mxnet_tpu_torch.ops import _build
    csrc = _build.CSRC
    src = (csrc / "flash_bwd.cu").read_text()
    srcs = {"change": csrc / "flash_bwd.cu",
            "parent": parent / "incubator_mxnet_tpu_torch" / "csrc"
            / "flash_bwd.cu"}
    for name, (b32, b64, b128) in variants.items():
        if src.count(BN_LINE) != 2:
            raise SystemExit(f"flash_bwd.cu has no two lines {BN_LINE!r}")
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "hopper_tc.cuh").write_text((csrc / "hopper_tc.cuh").read_text())
        (d / "flash_bwd.cu").write_text(src.replace(
            BN_LINE, f"static constexpr int BN = D == 32 ? {b32} : "
                     f"D == 64 ? {b64} : {b128};"))
        srcs[name] = d / "flash_bwd.cu"
    out.mkdir(parents=True, exist_ok=True)

    def nvcc(item):
        name, path = item
        lib = out / f"lib{name}.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(path)], capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {name}:\n{r.stdout}{r.stderr}")
        return name, (lib, r.stdout + r.stderr)

    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(pool.map(nvcc, srcs.items()))


def launcher(lib, torch):
    """flash_dq ("dq") or flash_dkv ("dkv") of a built library on fp32
    CUDA tensors, as ops/flash.py launches them."""
    def run(which, q, k, v, g, lse, delta, causal, scale, window):
        bh, lq, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, g, lse, delta)]
        if which == "dq":
            out = (torch.empty_like(q),)
            rc = lib.mxt_flash_dq(*ptrs, out[0].data_ptr(), bh, lq,
                                  k.shape[1], d, 0, int(causal), window,
                                  scale, stream)
        else:
            out = (torch.empty_like(k), torch.empty_like(v))
            rc = lib.mxt_flash_dkv(*ptrs, out[0].data_ptr(),
                                   out[1].data_ptr(), bh, lq, k.shape[1], d,
                                   0, int(causal), window, scale, stream)
        if rc:
            raise RuntimeError(lib.mxt_flash_bwd_error_string(rc).decode())
        return out
    return run


def kernels(parent, variants, out, torch):
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops import _build, flash

    runs = {}
    for name, (lib, log) in build_libs(parent, variants, out).items():
        report = cs.ptxas_report(log)
        emit({"build": name, "ptxas": {
            k: v for k, v in report.items()
            if "flash_d" in k or k == "wgmma_warnings"}})
        runs[name] = launcher(_build._bind(lib, flash._BWD_SIGNATURES),
                              torch)
    order = list(runs) + list(runs)[::-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 10)
    ok = True
    for case in cs.bwd_cases():
        if case["dtype"] != "float32":
            continue
        q, k, v, g = (torch.randn(case["bh"], n, case["d"], generator=gen,
                                  device="cuda")
                      for n in (case["lq"], case["lk"], case["lk"],
                                case["lq"]))
        causal, window = case["causal"], case["window"]
        scale = 1.0 / math.sqrt(case["d"])
        o, lse = flash.flash_attention_fwd(q, k, v, causal, scale, window)
        args = (q, k, v, g, lse, flash._delta(g, o), causal, scale, window)
        ref = flash._reference_bwd(q, k, v, o, lse, g, causal, scale,
                                   window)
        row = dict(case)
        for name, run in runs.items():
            got = run("dq", *args) + run("dkv", *args)
            again = run("dq", *args) + run("dkv", *args)
            worst = max(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max().item()
                        for a, b in zip(got, ref))
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            row[name] = {"worst_over_tol": worst, "bit_identical": same}
            ok = ok and worst <= 1.0 and same
        for name in order:
            for which in ("dq", "dkv"):
                row[name].setdefault(f"{which}_ms", []).append(cs.device_ms(
                    lambda: runs[name](which, *args), torch,
                    f"{name} {which}"))
        emit(row)
    return ok


def step(root):
    """Part 2 in a process of its own, on the package under ``root``."""
    sys.path[:0] = [str(root), str(REPO)]
    import numpy as np
    import torch

    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mt
    from incubator_mxnet_tpu_torch import rtc_examples as ex

    if not Path(mt.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {mt.__file__}, not the package under "
                         f"{root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mt.ops._build.build()
    net = cs.build_model(None)
    b, l = cs.TRAIN
    rs = np.random.RandomState(0)       # chip_smoke's tokens and labels
    toks, labels = (torch.from_numpy(rs.randint(
        0, cs.MODEL["vocab_size"], (b, l)).astype(np.int32)).cuda()
        for _ in range(2))
    record, _ = cs.fp32_train(mt, torch, net, toks, labels)
    del net
    torch.cuda.empty_cache()
    fn = ex.kernel("scale")
    x = torch.randn(cs.RTC_FULL, device="cuda")
    scale = []
    for _ in range(3):
        ms = cs.device_ms(lambda: fn(x, alpha=1.7), torch, "scale")
        mul = cs.device_ms(lambda: torch.mul(x, 1.7), torch, "torch.mul")
        scale.append({"ms": ms, "torch_mul_ms": mul, "ratio": ms / mul})
    emit({"root": str(root), "fp32_step": record, "scale": scale})
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=B32,B64,B128")
    ap.add_argument("--out", type=Path, default=REPO / "build"
                    / "compare_bwd")
    ap.add_argument("--step-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.step_root is not None:
        return step(args.step_root.resolve())
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("compare_bwd: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = args.parent.resolve()
    variants = {}
    for v in args.variant:
        name, rows = v.split("=")
        variants[name] = [int(r) for r in rows.split(",")]
    ok = kernels(parent, variants, args.out.resolve(), torch)
    for root in (parent, REPO, REPO, parent):
        r = subprocess.run([sys.executable, __file__, "--parent",
                            str(parent), "--step-root", str(root)],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if not ok:
        print("compare_bwd: a build disagrees with the plain backward or "
              "with itself", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
