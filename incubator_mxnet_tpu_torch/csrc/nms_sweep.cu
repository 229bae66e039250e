// Greedy non-maximum suppression for Hopper (sm_90a).
//
// The port's own kernel: it stands for a `lax` device loop, not for a
// Pallas kernel.  The JAX package builds a (k, k) suppression mask and
// runs the greedy sweep of MultiBoxDetection as a `lax.while_loop` and
// that of Proposal and MultiProposal as a `lax.fori_loop` (incubator_
// mxnet_tpu/ops/contrib_det.py:270-287, :505-516), and XLA keeps both
// loops on the device.  Here the same work needs no host synchronisation
// and runs inside a CUDA-graph capture.
//
// What it computes, for each image b:
//   alive = alive_in[b]
//   for i in [0, min(nkeep[b], n)):
//     if alive[i]: alive &= ~sup[b, i, :]
//   alive_out[b] = alive
// alive_in (B, n) is bool (one byte a row), nkeep (B,) int64 on the
// device, and sup[b, i, j] is "row i suppresses the later row j": j > i,
// both alive in alive_in, the same class (unless no classes are given)
// and IoU >= the threshold.  mxt_nms_boxes goes from the boxes:
// nms_pair_kernel writes those bits, then nms_sweep_kernel sweeps them.
// No (B, n, n) tensor is made.
//
// Bits are packed 32 columns a word: bit j % 32 of word j / 32 of row i,
// rows of W = ceil(n / 32) words in the scratch the wrapper allocates.
//
//   nms_pair_kernel   one thread tests one row against one 32-column word;
//                     a block is one row block (32 rows, 4 to a warp) by
//                     32 words (a lane each), its 1024 columns' boxes,
//                     areas and keys (the class of an alive column, NaN of
//                     a dead one) staged in shared memory, and the grid
//                     spreads the tiles of every image over the card.
//                     Only words on or right of a row's diagonal word
//                     (i / 32) are written, and rows at or past nkeep not
//                     at all: the sweep never reads either.  The IoU is
//                     `_iou_corner`'s (or, with pixel_offset,
//                     `_proposal_iou`'s +1-pixel) arithmetic op for op,
//                     each op rounded on its own (__fsub_rn, __fmul_rn,
//                     __fadd_rn, __fdiv_rn: nvcc would fuse a multiply and
//                     an add), min and max propagating NaN as
//                     torch.minimum and torch.maximum do, and the
//                     threshold compared as a float, as torch compares a
//                     float32 tensor with a Python number.  So the bits
//                     equal the plain version's torch ops.
//   nms_sweep_kernel  one block an image; thread t owns the alive words
//                     t, t + blockDim (MAXW of them) in registers.  It
//                     takes 32 rows a barrier: the owner of row block
//                     rb's word (rows 32 rb .. 32 rb + 31) resolves the
//                     block's rows in order in registers from their 32
//                     diagonal words, which warp 0 loads into shared
//                     memory a row block ahead, and publishes the rows it
//                     took through shared memory; after the barrier every
//                     thread clears its words with the taken rows only,
//                     up to 32 loads in flight a thread, so a dead row
//                     costs no load.  Words left of rb hold no bit (the
//                     mask is strictly upper-triangular) and are neither
//                     written nor read.
//
// What bounds it: the work the semantics need is an IoU test of each
// taken row against each later row of its class, and the boxes read
// once: a few microseconds at SSD300's size.  The pair test instead scans
// every pair of the window (a compare of keys a pair, the IoU for the
// candidates only), so no test waits on the greedy order; the sweep is
// serial in its row blocks, each a barrier, the owner's 32-step resolve
// and the taken rows' loads, on B SMs.  The design that tests only the
// taken rows' pairs, one block an image with the boxes in shared memory
// and a barrier a taken row, lost to this one on every window timed
// (tools/sweep_variants.py, PERF.md).
//
// Size: a sweep block has at most SWEEP_THREADS = 512 threads, and a
// thread holds one alive word in registers up to 512 words (n <= 16384,
// every NMS window of the ops' models) or four up to 65536 rows.
// __launch_bounds__(512, 1) leaves a thread 128 registers for its loads
// in flight.  Above 65536 rows nms_sweep_shared_kernel keeps an image's
// alive bits in shared memory instead (n / 8 bytes: 16 KB at 131072
// rows), which the card's 227 KB a block bound at about 1.85M rows; the
// scratch, n * n / 8 bytes an image (2 GB at 131072 rows), is the
// limit that binds first.  A batch above 65535 images is folded into the
// pair test's grid.x.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SWEEP_THREADS = 512;   // the sweep's largest block
constexpr int PAIR_WARPS = 8;        // a pair-test block: 8 warps, 32 rows

// torch.minimum / torch.maximum: NaN in, NaN out (fminf and fmaxf drop it)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// (x2 - x0) * (y2 - y0), or with pixel_offset (x2 - x0 + 1) * (y2 - y0 + 1)
__device__ __forceinline__ float box_area(float4 b, bool pixel) {
  float w = __fsub_rn(b.z, b.x);
  float h = __fsub_rn(b.w, b.y);
  if (pixel) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
  }
  return __fmul_rn(w, h);
}

// IoU(a, b) >= thr in the plain version's arithmetic: _iou_corner (union
// <= 0 gives IoU 0) or, with pixel_offset, _proposal_iou (no guard).
__device__ __forceinline__ bool iou_at_least(float4 a, float area_a,
                                             float4 b, float area_b,
                                             float thr, bool pixel) {
  float w = __fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x));
  float h = __fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y));
  if (pixel) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
  }
  w = max_nan(w, 0.0f);
  h = max_nan(h, 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // 0 / union with union > 0 is 0 exactly: no division needed
  if (uni > 0.0f && inter == 0.0f) return 0.0f >= thr;
  if (!pixel && !(uni > 0.0f)) return 0.0f >= thr;
  return __fdiv_rn(inter, uni) >= thr;
}

__device__ __forceinline__ int clamp_rows(long long nk, int n) {
  return nk < 0 ? 0 : (nk > n ? n : static_cast<int>(nk));
}

// Kernel (a).  Block (x, y, b): the rows of row block y (32 rows, a warp
// taking every 8th) against words y + 32 x .. y + 32 x + 31 (a lane
// each) of image b.
__global__ void __launch_bounds__(PAIR_WARPS * 32)
nms_pair_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ cls,
                const uint8_t* __restrict__ alive,
                const long long* __restrict__ nkeep,
                uint32_t* __restrict__ bits, int batch, int n, int words,
                int xtiles, float thr, int pixel_offset) {
  // column 32 (w0 + l) + c of the tile sits at c * 33 + l, so the lanes
  // of a warp read neighbours.  A column's key is its class if it is
  // alive and NaN (equal to nothing) if not, so one compare tests both.
  __shared__ float4 s_box[32 * 33];
  __shared__ float s_area[32 * 33];
  __shared__ float s_key[32 * 33];
  const bool pixel = pixel_offset != 0;
  // grid.x holds gridDim.x / xtiles images of a z slice, xtiles each
  const int b = blockIdx.z * (gridDim.x / xtiles) + blockIdx.x / xtiles;
  if (b >= batch) return;
  const int rb = blockIdx.y;
  const int i0 = 32 * rb;
  const int stop = clamp_rows(nkeep[b], n);
  const int w0 = rb + 32 * (blockIdx.x % xtiles);  // the tile's first word
  if (i0 >= stop || w0 >= words) return;          // uniform in the block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long base = static_cast<long long>(b) * n;
  for (int q = tid; q < 1024; q += PAIR_WARPS * 32) {
    const int j = 32 * w0 + q;
    const int s = (q & 31) * 33 + (q >> 5);
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float key = __int_as_float(0x7fc00000);       // NaN
    if (j < n) {
      box = boxes[base + j];
      if (alive[base + j]) key = cls ? cls[base + j] : 0.0f;
    }
    s_box[s] = box;
    s_area[s] = box_area(box, pixel);
    s_key[s] = key;
  }
  __syncthreads();
  const int w = w0 + lane;
  if (w >= words) return;
  for (int i = i0 + (tid >> 5); i < i0 + 32 && i < stop; i += PAIR_WARPS) {
    uint32_t word = 0;
    if (alive[base + i]) {
      const float4 a = boxes[base + i];
      const float area_a = box_area(a, pixel);
      const float ca = cls ? cls[base + i] : 0.0f;
      // the candidates: later columns, alive, of the row's class; then
      // the IoU of those only, so a lane with none does not hold its
      // warp through the test
      const int first = w == rb ? (i & 31) + 1 : 0;
      uint32_t cand = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c >= first && s_key[c * 33 + lane] == ca) cand |= 1u << c;
      while (cand) {
        const int c = __ffs(cand) - 1;
        cand &= cand - 1;
        const int s = c * 33 + lane;
        if (iou_at_least(a, area_a, s_box[s], s_area[s], thr, pixel))
          word |= 1u << c;
      }
    }
    bits[(base + i) * words + w] = word;
  }
}

// Kernel (b).  MAXW: alive words a thread, so n <= 32 * SWEEP_THREADS *
// MAXW; a taken row block's taken rows are loaded CHUNK at a time: 32
// (one word a thread) or 8 (four), 32 loads in flight a thread (on an
// H100 the sweep of 65536 random boxes took 11.1 ms at 8, 13.2 at 4).
// Only words right of a row block's diagonal word are read: the pair
// test writes no bit left of it.
template <int MAXW>
__global__ void __launch_bounds__(SWEEP_THREADS, 1)
nms_sweep_kernel(const uint32_t* __restrict__ bits,
                 const uint8_t* __restrict__ alive_in,
                 const long long* __restrict__ nkeep,
                 uint8_t* __restrict__ alive_out, int n, int words) {
  constexpr int CHUNK = MAXW == 1 ? 32 : 8;
  __shared__ __align__(16) uint32_t s_diag[2][32];   // diagonal words
  __shared__ uint32_t s_taken[2];      // the rows it took, a bit each
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  // an image's words: n * words <= 2^27, so int offsets
  const uint32_t* mask = bits + static_cast<long long>(b) * n * words;
  const uint8_t* in = alive_in + static_cast<long long>(b) * n;
  uint8_t* out = alive_out + static_cast<long long>(b) * n;

  uint32_t alive[MAXW];
#pragma unroll
  for (int m = 0; m < MAXW; ++m) {
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

  const int stop = clamp_rows(nkeep[b], n);
  const int blocks = (stop + 31) >> 5;
  // lane r of warp 0: row 32 rb + r's diagonal word, in flight a row
  // block ahead of its use
  auto diag = [&](int rb) -> uint32_t {
    const int i = 32 * rb + tid;
    return (rb < blocks && i < stop) ? __ldg(mask + i * words + rb) : 0u;
  };
  uint32_t next = 0;
  if (tid < 32) {
    s_diag[0][tid] = diag(0);
    next = diag(1);
  }
  __syncthreads();

  // word rb's owner: thread owner, its alive word slot
  for (int rb = 0, owner = 0, slot = 0; rb < blocks; ++rb) {
    const int buf = rb & 1;
    if (tid == owner) {
      // resolve the block's rows in order: a row alive when reached is
      // taken and clears what its diagonal word suppresses
      uint32_t a = 0;
#pragma unroll
      for (int m = 0; m < MAXW; ++m)
        if (m == slot) a = alive[m];
      const int lim = stop - 32 * rb;
      const uint32_t live = lim >= 32 ? 0xffffffffu : (1u << lim) - 1u;
      uint32_t took = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(s_diag[buf])[q];
        const uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t row = a & live & (1u << (4 * q + t));
          took |= row;
          if (row) a &= ~d[t];
        }
      }
#pragma unroll
      for (int m = 0; m < MAXW; ++m)
        if (m == slot) alive[m] = a;
      s_taken[buf] = took;
    }
    if (++owner == bd) {
      owner = 0;
      ++slot;
    }
    if (tid < 32) {
      s_diag[buf ^ 1][tid] = next;
      next = diag(rb + 2);
    }
    __syncthreads();
    // the taken rows clear the words right of rb (word rb is the
    // owner's, done above).  CHUNK taken rows are loaded at a time; t is
    // the same in every thread, so the loop does not diverge.
    bool ok[MAXW];
#pragma unroll
    for (int m = 0; m < MAXW; ++m) {
      const int w = tid + m * bd;
      ok[m] = w < words && w > rb;
    }
    const uint32_t* block = mask + 32 * rb * words + tid;
    for (uint32_t t = s_taken[buf]; t;) {
      uint32_t rows[CHUNK][MAXW];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        int r = -1;
        if (t) {
          r = __ffs(t) - 1;
          t &= t - 1;
        }
#pragma unroll
        for (int m = 0; m < MAXW; ++m)
          rows[k][m] = r >= 0 && ok[m] ? __ldg(block + r * words + m * bd)
                                       : 0u;
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
#pragma unroll
        for (int m = 0; m < MAXW; ++m) alive[m] &= ~rows[k][m];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MAXW; ++m) {
    int w = tid + m * bd;
    if (w >= words) continue;
    for (int bit = 0; bit < 32; ++bit) {
      int j = w * 32 + bit;
      if (j < n) out[j] = (alive[m] >> bit) & 1u;
    }
  }
}

// Kernel (c), above 65536 rows: kernel (b) with the alive words in
// shared memory, thread t owning words t, t + blockDim, ...  Word rb and
// row block rb have one owner, so the resolve reads and writes its own
// word; after the barrier each thread clears its words right of rb with
// the taken rows, 8 loads in flight.  Offsets into the image's words are
// 64-bit: n * words passes 2^31 above 262144 rows.
__global__ void __launch_bounds__(SWEEP_THREADS, 1)
nms_sweep_shared_kernel(const uint32_t* __restrict__ bits,
                        const uint8_t* __restrict__ alive_in,
                        const long long* __restrict__ nkeep,
                        uint8_t* __restrict__ alive_out, int n,
                        int words) {
  extern __shared__ uint32_t s_alive[];
  __shared__ __align__(16) uint32_t s_diag[2][32];
  __shared__ uint32_t s_taken[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const uint32_t* mask = bits + static_cast<long long>(b) * n * words;
  const uint8_t* in = alive_in + static_cast<long long>(b) * n;
  uint8_t* out = alive_out + static_cast<long long>(b) * n;
  for (int w = tid; w < words; w += bd) {
    uint32_t word = 0;
    for (int bit = 0; bit < 32; ++bit) {
      const int j = w * 32 + bit;
      if (j < n && in[j]) word |= 1u << bit;
    }
    s_alive[w] = word;
  }

  const int stop = clamp_rows(nkeep[b], n);
  const int blocks = (stop + 31) >> 5;
  auto diag = [&](int rb) -> uint32_t {
    const int i = 32 * rb + tid;
    return (rb < blocks && i < stop)
               ? __ldg(mask + static_cast<long long>(i) * words + rb)
               : 0u;
  };
  uint32_t next = 0;
  if (tid < 32) {
    s_diag[0][tid] = diag(0);
    next = diag(1);
  }
  __syncthreads();

  for (int rb = 0; rb < blocks; ++rb) {
    const int buf = rb & 1;
    if (tid == rb % bd) {
      uint32_t a = s_alive[rb];
      const int lim = stop - 32 * rb;
      const uint32_t live = lim >= 32 ? 0xffffffffu : (1u << lim) - 1u;
      uint32_t took = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(s_diag[buf])[q];
        const uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t row = a & live & (1u << (4 * q + t));
          took |= row;
          if (row) a &= ~d[t];
        }
      }
      s_alive[rb] = a;
      s_taken[buf] = took;
    }
    if (tid < 32) {
      s_diag[buf ^ 1][tid] = next;
      next = diag(rb + 2);
    }
    __syncthreads();
    const uint32_t taken = s_taken[buf];
    if (!taken) continue;
    const uint32_t* block = mask + 32LL * rb * words;
    // this thread's first word right of rb
    const int w0 = tid > rb ? tid : tid + ((rb - tid) / bd + 1) * bd;
    for (int w = w0; w < words; w += bd) {
      uint32_t acc = 0;
      for (uint32_t t = taken; t;) {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int r = -1;
          if (t) {
            r = __ffs(t) - 1;
            t &= t - 1;
          }
          v[k] = r >= 0 ? __ldg(block + static_cast<long long>(r) * words + w)
                        : 0u;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc |= v[k];
      }
      s_alive[w] &= ~acc;
    }
  }

  for (int w = tid; w < words; w += bd) {
    const uint32_t word = s_alive[w];
    for (int bit = 0; bit < 32; ++bit) {
      const int j = w * 32 + bit;
      if (j < n) out[j] = (word >> bit) & 1u;
    }
  }
}

// Launch the sweep of n rows: one word a thread in registers up to
// SWEEP_THREADS words (n <= 16384), four up to 65536 rows, else the words
// in shared memory; -3 where they do not fit the card's shared memory.
int launch_sweep(const uint32_t* bits, const void* alive_in,
                 const void* nkeep, void* alive_out, int batch, int n,
                 cudaStream_t s) {
  const int words = (n + 31) / 32;
  const uint8_t* in = static_cast<const uint8_t*>(alive_in);
  const long long* nk = static_cast<const long long*>(nkeep);
  uint8_t* out = static_cast<uint8_t*>(alive_out);
  if (words <= SWEEP_THREADS) {
    nms_sweep_kernel<1><<<batch, ((words + 31) / 32) * 32, 0, s>>>(
        bits, in, nk, out, n, words);
  } else if (words <= 4 * SWEEP_THREADS) {
    nms_sweep_kernel<4><<<batch, SWEEP_THREADS, 0, s>>>(
        bits, in, nk, out, n, words);
  } else {
    const size_t smem = static_cast<size_t>(words) * sizeof(uint32_t);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the static s_diag and s_taken take 264 bytes
    if (smem + 1024 > static_cast<size_t>(optin)) return -3;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(nms_sweep_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    nms_sweep_shared_kernel<<<batch, SWEEP_THREADS, smem, s>>>(
        bits, in, nk, out, n, words);
  }
  return 0;
}

}  // namespace

// boxes: (batch, n, 4) float32 corner boxes, 16-byte aligned; cls:
// (batch, n) float32, or null for no class test; alive_in, alive_out:
// (batch, n) bool; nkeep: (batch,) int64; scratch: batch * n * ceil(n /
// 32) uint32 words, of which the sweep reads only what the pair test
// wrote; pixel_offset: 0 for _iou_corner, 1 for _proposal_iou.  sweep: 0
// runs the pair test alone (the words are the result).  Returns 0 on
// success, a cudaError_t from the launches, or -3 for sizes the kernels
// do not take (negative, or an image's alive bits above the card's
// shared memory a block: about 1.85M rows on an H100).
extern "C" int mxt_nms_boxes(const void* boxes, const void* cls,
                             const void* alive_in, const void* nkeep,
                             void* alive_out, void* scratch, int batch,
                             int n, float threshold, int pixel_offset,
                             int sweep, void* stream) {
  if (batch < 0 || n < 0) return -3;
  if (batch == 0 || n == 0) return 0;
  const int words = (n + 31) / 32;
  if (words > 65535) return -3;                   // grid.y of the pair test
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  const int xtiles = (words + 31) / 32;
  const int fold = (batch + 65534) / 65535;       // images a z slice
  const dim3 grid(xtiles * fold, words, (batch + fold - 1) / fold);
  nms_pair_kernel<<<grid, PAIR_WARPS * 32, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(cls),
      static_cast<const uint8_t*>(alive_in),
      static_cast<const long long*>(nkeep), bits, batch, n, words, xtiles,
      threshold, pixel_offset);
  const int rc = sweep ? launch_sweep(bits, alive_in, nkeep, alive_out,
                                      batch, n, s) : 0;
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" const char* mxt_nms_error_string(int code) {
  if (code == -3) return "bad sizes (negative, or an image's alive bits "
                         "above the card's shared memory a block)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
