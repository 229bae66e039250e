#!/usr/bin/env python3
"""Time the shipped greedy NMS (``csrc/nms_sweep.cu``'s ``nms_boxes``)
against the designs beside it, on one NVIDIA card.

    python3 incubator_mxnet_tpu_torch/tools/sweep_variants.py

On chip_smoke.py's ``nms_cases``, the shipped ``nms_boxes`` (the pair
test of every pair of the window, packed 32 bits a word, then a sweep
that takes 32 rows a barrier) against:

- the design it replaced (``replaced``): the mask built by torch ops, then
  a pack of its bool bytes (``byte_pack_kernel``) and a sweep that
  offers each row's alive bit to ``__syncthreads_or``, 16 rows read
  ahead, every row read, taken or not (``row_sweep_kernel``).  Only the
  pack and the sweep are timed, on a mask built beforehand: the mask's
  torch ops are the plain version's, timed by chip_smoke.py;
- one kernel an image that tests the taken rows' pairs only
  (``single_kernel``: the window's boxes, areas, classes and alive
  bytes in dynamic shared memory, each taken row's IoUs with the later
  rows computed by the block's threads, a barrier a taken row), at 1024
  and 256 threads, on the windows whose boxes fit in shared memory.

The variants are the shipped source with their kernels appended, so
they share its IoU arithmetic.  Every design is held bit for bit
against the plain version (``_sweep_plain`` of chip_smoke.py's
``plain_mask``); then each is timed on the device's clock
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

SHIPPED = ROOT / "incubator_mxnet_tpu_torch" / "csrc" / "nms_sweep.cu"
SINGLE_THREADS = (1024, 256)
TURNS = 3

VARIANTS = r"""
namespace {

constexpr int ROW_AHEAD = 16;   // rows read ahead per round
constexpr int ROW_MAXW = 2;     // alive words a thread: n <= 65536
constexpr int SINGLE_SMEM = 232448;   // an sm_90 block's shared memory

// one thread per 32 columns of a row packs the row's bool bytes
__global__ void byte_pack_kernel(const uint8_t* __restrict__ sup,
                                 uint32_t* __restrict__ bits,
                                 long long rows, int n, int words) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
  if (idx >= rows * words) return;
  long long r = idx / words;
  int w = static_cast<int>(idx - r * words);
  const uint8_t* row = sup + r * n;
  int j0 = w * 32;
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    int j = j0 + b;
    if (j < n && row[j]) word |= 1u << b;
  }
  bits[idx] = word;
}

__global__ void __launch_bounds__(1024)
row_sweep_kernel(const uint32_t* __restrict__ bits,
                 const uint8_t* __restrict__ alive_in,
                 const long long* __restrict__ nkeep,
                 uint8_t* __restrict__ alive_out, int n, int words) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const uint32_t* mask = bits + static_cast<long long>(b) * n * words;
  const uint8_t* in = alive_in + static_cast<long long>(b) * n;
  uint8_t* out = alive_out + static_cast<long long>(b) * n;

  uint32_t alive[ROW_MAXW];
#pragma unroll
  for (int m = 0; m < ROW_MAXW; ++m) {
    int w = tid + m * bd;
    uint32_t word = 0;
    if (w < words) {
      for (int bit = 0; bit < 32; ++bit) {
        int j = w * 32 + bit;
        if (j < n && in[j]) word |= 1u << bit;
      }
    }
    alive[m] = word;
  }

  long long nk = nkeep[b];
  const int stop = nk < 0 ? 0 : (nk > n ? n : static_cast<int>(nk));
  for (int i0 = 0; i0 < stop; i0 += ROW_AHEAD) {
    uint32_t rows[ROW_AHEAD][ROW_MAXW];
#pragma unroll
    for (int r = 0; r < ROW_AHEAD; ++r) {
#pragma unroll
      for (int m = 0; m < ROW_MAXW; ++m) {
        int w = tid + m * bd;
        int i = i0 + r;
        rows[r][m] = (i < stop && w < words)
            ? __ldg(mask + static_cast<long long>(i) * words + w) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < ROW_AHEAD; ++r) {
      const int i = i0 + r;
      if (i >= stop) break;                       // uniform
      const int word = i >> 5;
      const int owner = word % bd;
      const int slot = word / bd;
      int mine = 0;
      if (tid == owner) {
#pragma unroll
        for (int m = 0; m < ROW_MAXW; ++m)
          if (m == slot) mine = (alive[m] >> (i & 31)) & 1u;
      }
      if (__syncthreads_or(mine)) {
#pragma unroll
        for (int m = 0; m < ROW_MAXW; ++m) alive[m] &= ~rows[r][m];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < ROW_MAXW; ++m) {
    int w = tid + m * bd;
    if (w >= words) continue;
    for (int bit = 0; bit < 32; ++bit) {
      int j = w * 32 + bit;
      if (j < n) out[j] = (alive[m] >> bit) & 1u;
    }
  }
}

__global__ void __launch_bounds__(1024)
single_kernel(const float4* __restrict__ boxes,
              const float* __restrict__ cls,
              const uint8_t* __restrict__ alive_in,
              const long long* __restrict__ nkeep,
              uint8_t* __restrict__ alive_out, int n, float thr,
              int pixel_offset) {
  extern __shared__ float4 s_box[];
  float* s_area = reinterpret_cast<float*>(s_box + n);
  float* s_cls = s_area + n;
  uint8_t* s_alive = reinterpret_cast<uint8_t*>(s_cls + n);
  const bool pixel = pixel_offset != 0;
  const int b = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;
  const long long base = static_cast<long long>(b) * n;
  for (int j = tid; j < n; j += bd) {
    const float4 box = boxes[base + j];
    s_box[j] = box;
    s_area[j] = box_area(box, pixel);
    s_cls[j] = cls ? cls[base + j] : 0.0f;
    s_alive[j] = alive_in[base + j];
  }
  __syncthreads();
  const int stop = clamp_rows(nkeep[b], n);
  for (int i = 0; i < stop; ++i) {
    // nothing was written since the last barrier, and a taken row's
    // threads write only rows past it: every thread reads the same
    if (!s_alive[i]) continue;
    const float4 a = s_box[i];
    const float area_a = s_area[i];
    const float ca = s_cls[i];
    for (int j = i + 1 + tid; j < n; j += bd)
      if (s_alive[j] && (!cls || s_cls[j] == ca)
          && iou_at_least(a, area_a, s_box[j], s_area[j], thr, pixel))
        s_alive[j] = 0;
    __syncthreads();
  }
  for (int j = tid; j < n; j += bd) alive_out[base + j] = s_alive[j];
}

}  // namespace

extern "C" int row_sweep(const void* sup, const void* alive_in,
                         const void* nkeep, void* alive_out, void* scratch,
                         int batch, int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int words = (n + 31) / 32;
  int threads = ((words + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if ((words + threads - 1) / threads > ROW_MAXW) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  const long long packs = static_cast<long long>(batch) * n * words;
  byte_pack_kernel<<<static_cast<unsigned>((packs + 255) / 256), 256, 0,
                     s>>>(static_cast<const uint8_t*>(sup), bits,
                          static_cast<long long>(batch) * n, n, words);
  row_sweep_kernel<<<batch, threads, 0, s>>>(
      bits, static_cast<const uint8_t*>(alive_in),
      static_cast<const long long*>(nkeep),
      static_cast<uint8_t*>(alive_out), n, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int single_nms(const void* boxes, const void* cls,
                          const void* alive_in, const void* nkeep,
                          void* alive_out, int batch, int n, float thr,
                          int pixel_offset, int threads, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = static_cast<size_t>(n) * (16 + 4 + 4 + 1);
  if (smem > SINGLE_SMEM) return -3;
  cudaFuncSetAttribute(single_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  single_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float4*>(boxes),
                 static_cast<const float*>(cls),
                 static_cast<const uint8_t*>(alive_in),
                 static_cast<const long long*>(nkeep),
                 static_cast<uint8_t*>(alive_out), n, thr, pixel_offset);
  return static_cast<int>(cudaGetLastError());
}
"""
SINGLE_BYTES_A_ROW = 16 + 4 + 4 + 1   # single_kernel's shared memory
SINGLE_SMEM = 232448
SIGNATURES = {
    "row_sweep": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p], ctypes.c_int),
    "single_nms": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p], ctypes.c_int),
}


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
    lib = mt.ops._build.load_source(SHIPPED.read_text() + VARIANTS,
                                    "nms_variants", SIGNATURES)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed: {rc}")

    def row_sweep(sup, alive, nkeep):
        batch, n = alive.shape
        out = torch.empty_like(alive)
        scratch = torch.empty(batch * n * ((n + 31) // 32),
                              dtype=torch.int32, device=alive.device)
        checked(lib.row_sweep(sup.data_ptr(), alive.data_ptr(),
                              nkeep.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), batch, n, stream()),
                "row_sweep")
        return out

    def single(threads):
        def run(boxes, cls, alive, nkeep, thr, force, pixel):
            cls = None if force else cls
            out = torch.empty_like(alive)
            checked(lib.single_nms(
                boxes.data_ptr(), None if cls is None else cls.data_ptr(),
                alive.data_ptr(), nkeep.data_ptr(), out.data_ptr(),
                alive.shape[0], alive.shape[1], float(thr), int(pixel),
                threads, stream()), "single_nms")
            return out
        return run

    def replaced(sup):
        def run(boxes, cls, alive, nkeep, *_):
            return row_sweep(sup, alive, nkeep)
        return run

    result = {}
    for case, args in cs.nms_cases(mt, torch, np).items():
        batch, n = args[2].shape
        sup = cs.plain_mask(cd, torch, args)
        ref = cd._sweep_plain(sup, args[2], args[3])
        designs = {"shipped": cd.nms_boxes, "replaced": replaced(sup)}
        if n * SINGLE_BYTES_A_ROW <= SINGLE_SMEM:
            designs.update({f"single_t{t}": single(t)
                            for t in SINGLE_THREADS})
        ms = {}
        for name, fn in designs.items():
            if not torch.equal(fn(*args), ref):
                print(f"sweep_variants: {name} differs from the plain "
                      f"version on {case}", file=sys.stderr)
                return 1
            ms[name] = []
        for _ in range(TURNS):
            for name, fn in designs.items():
                ms[name].append(cs.device_ms(
                    lambda fn=fn: fn(*args), torch, f"{name} {case}",
                    warmup=1, reps=3))
        result[case] = {"batch": batch, "rows": n,
                        "alive": int(ref.sum()), "ms": ms,
                        "median_ms": {k: sorted(v)[len(v) // 2]
                                      for k, v in ms.items()}}
        print(case, json.dumps(result[case]["median_ms"]), flush=True)
        del sup, designs
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
