#!/usr/bin/env python3
"""Time the shipped greedy-NMS sweep (``csrc/nms_sweep.cu``: a pack
kernel, then one block an image with the alive words in registers and
16 rows read ahead) against the single-kernel design on one NVIDIA
card.

    python3 incubator_mxnet_tpu_torch/tools/sweep_variants.py

The single-kernel design is ``SOURCE`` below: one block an image, the
alive bits as bytes in shared memory, and only the rows of the alive
rows read, straight from the bool mask, ``V`` columns a load (1: a byte,
4: a 32-bit word), in blocks of ``threads``.  A column is read and
written by one thread only, so one ``__syncthreads_or`` a row carries
the decision.  The masks are chip_smoke.py's ``sweep_masks``: the
SSD300 detections at nms_topk 400 and -1 (32 x 8732), the RPN proposals
at pre_n 6000, and a random mask at the shipped kernel's largest size
(65536 rows).  Every design is held bit for bit against
``_sweep_plain``; then each is timed on the device's clock
(chip_smoke.py's ``device_ms``), in turns.  Prints the card and one
JSON object: each case's samples and medians.  Run from the repository
root; exits non-zero without a CUDA card.
"""
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (columns a load, threads a block)
VARIANTS = ((1, 1024), (4, 256), (4, 1024))
TURNS = 3

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int V>
__global__ void sweep(const uint8_t* __restrict__ sup,
                      const uint8_t* __restrict__ alive_in,
                      const long long* __restrict__ nkeep,
                      uint8_t* __restrict__ alive_out, int n) {
  extern __shared__ uint8_t alive[];
  const int b = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;
  const uint8_t* mask = sup + static_cast<long long>(b) * n * n;
  for (int j = tid; j < n; j += bd)
    alive[j] = alive_in[static_cast<long long>(b) * n + j];
  const long long nk = nkeep[b];
  const int stop = nk < 0 ? 0 : (nk > n ? n : static_cast<int>(nk));
  const int groups = (n + V - 1) / V;
  for (int i = 0; i < stop; ++i) {
    // thread (i / V) % bd alone reads and writes column i
    if (__syncthreads_or(tid == (i / V) % bd && alive[i])) {
      const uint8_t* row = mask + static_cast<long long>(i) * n;
      if (V == 1) {
        for (int j = tid; j < n; j += bd)
          if (__ldg(row + j)) alive[j] = 0;
      } else {
        const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
        for (int g = tid; g < groups; g += bd) {
          const uint32_t v = __ldg(row4 + g);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if ((v >> (8 * c)) & 0xffu) alive[4 * g + c] = 0;
        }
      }
    }
  }
  for (int j = tid; j < n; j += bd)
    alive_out[static_cast<long long>(b) * n + j] = alive[j];
}

// V = 4 needs n % 4 == 0 (each row then starts on a word).
extern "C" int sweep_single(const void* sup, const void* alive_in,
                            const void* nkeep, void* alive_out, int batch,
                            int n, int v, int threads, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (v == 4 && n % 4) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = v == 4 ? sweep<4> : sweep<1>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       n);
  kernel<<<batch, threads, n, s>>>(
      static_cast<const uint8_t*>(sup),
      static_cast<const uint8_t*>(alive_in),
      static_cast<const long long*>(nkeep),
      static_cast<uint8_t*>(alive_out), n);
  return static_cast<int>(cudaGetLastError());
}
"""
SIGNATURES = {"sweep_single": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p], ctypes.c_int)}


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mt
    cd = mt.ops.contrib_det

    print(cs.card_line(), flush=True)
    lib = mt.ops._build.load_source(SOURCE, "nms_sweep_single", SIGNATURES)

    def single(v, threads):
        def run(sup, alive, nkeep):
            out = torch.empty_like(alive)
            rc = lib.sweep_single(
                sup.data_ptr(), alive.data_ptr(), nkeep.data_ptr(),
                out.data_ptr(), alive.shape[0], alive.shape[1], v, threads,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"sweep_single failed: {rc}")
            return out
        return run

    designs = {"shipped": cd.nms_sweep}
    designs.update({f"single_v{v}_t{t}": single(v, t) for v, t in VARIANTS})
    result = {}
    for case, (sup, alive, nkeep) in cs.sweep_masks(mt, torch, np).items():
        nkeep = nkeep.to(torch.int64)
        ref = cd._sweep_plain(sup, alive, nkeep)
        ms = {}
        for name, fn in designs.items():
            if not torch.equal(fn(sup, alive, nkeep), ref):
                print(f"sweep_variants: {name} differs from the plain "
                      f"version on {case}", file=sys.stderr)
                return 1
            ms[name] = []
        for _ in range(TURNS):
            for name, fn in designs.items():
                ms[name].append(cs.device_ms(
                    lambda fn=fn: fn(sup, alive, nkeep), torch,
                    f"{name} {case}", warmup=1, reps=3))
        result[case] = {"batch": alive.shape[0], "rows": alive.shape[1],
                        "alive": int(ref.sum()), "ms": ms,
                        "median_ms": {k: sorted(v)[len(v) // 2]
                                      for k, v in ms.items()}}
        print(case, json.dumps(result[case]["median_ms"]), flush=True)
        del sup, alive, nkeep, ref
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
