// Greedy non-maximum-suppression sweep for Hopper (sm_90a).
//
// The port's own kernel: it stands for a `lax` device loop, not for a
// Pallas kernel.  The JAX package runs the greedy sweep of
// MultiBoxDetection as a `lax.while_loop` and that of Proposal and
// MultiProposal as a `lax.fori_loop` (incubator_mxnet_tpu/ops/
// contrib_det.py:280-287, :513-516), and XLA keeps both loops on the
// device.  Here the same loop is one block an image, so it needs no host
// synchronisation and runs inside a CUDA-graph capture.
//
// What it computes, for each image b:
//   alive = alive_in[b]
//   for i in [0, min(nkeep[b], n)):
//     if alive[i]: alive &= ~sup[b, i, :]
//   alive_out[b] = alive
// sup (B, n, n) and alive_in (B, n) are bool (one byte each), nkeep (B,)
// int64 on the device.  The mask is built by torch ops on the card, the
// same ops as the plain version's, so the sweep is bit-equal to the plain
// version by construction: it only reads bits and clears bits.
//
// Two kernels, one launch of the C entry point:
//   nms_pack_kernel   one thread per 32 columns of a row packs the row's
//                     bool bytes into a 32-bit word (bit j % 32 of word
//                     j / 32), for every row of every image, so the sweep
//                     reads an eighth of the bytes;
//   nms_sweep_kernel  one block per image; thread t owns the alive words
//                     t, t + blockDim, ... (at most MAXW) in registers.
//                     Rows are read R at a time into registers (R loads
//                     in flight per word, coalesced across the block),
//                     then taken in order: the owner of row i's alive bit
//                     offers it to __syncthreads_or, which is also the
//                     barrier that orders row i - 1's clears before row
//                     i's test, and if it is set every thread clears its
//                     words with row i.  No shared memory, no atomics.
//
// What bounds it: the semantics need the rows of the alive i only, n
// bytes each as bool, and alive read and written once; the pack reads
// every row once and the sweep a row per i < nkeep whether alive or not,
// so a dead row costs a barrier and an eighth of its bytes.  The
// single-kernel design (alive bytes in shared memory, the bool rows of
// the alive i read directly, no pack) lost to this one on every mask
// timed (tools/sweep_variants.py, PERF.md): each alive row then waits
// for its own load.
//
// Size: a block has at most 1024 threads and a thread MAXW words, so
// n <= 32 * 1024 * MAXW = 65536.  __launch_bounds__(1024) holds the
// sweep to the 64 registers a thread that a 1024-thread block may use;
// the read-ahead takes R * MAXW = 32 of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;       // rows read ahead per round
constexpr int MAXW = 2;     // alive words per thread: n <= 32 * 1024 * MAXW

__global__ void nms_pack_kernel(const uint8_t* __restrict__ sup,
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
nms_sweep_kernel(const uint32_t* __restrict__ bits,
                 const uint8_t* __restrict__ alive_in,
                 const long long* __restrict__ nkeep,
                 uint8_t* __restrict__ alive_out, int n, int words) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
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

  long long nk = nkeep[b];
  const int stop = nk < 0 ? 0 : (nk > n ? n : static_cast<int>(nk));
  for (int i0 = 0; i0 < stop; i0 += R) {
    uint32_t rows[R][MAXW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = 0; m < MAXW; ++m) {
        int w = tid + m * bd;
        int i = i0 + r;
        rows[r][m] = (i < stop && w < words)
            ? __ldg(mask + static_cast<long long>(i) * words + w) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i >= stop) break;                       // uniform
      const int word = i >> 5;
      const int owner = word % bd;
      const int slot = word / bd;
      int mine = 0;
      if (tid == owner) {
#pragma unroll
        for (int m = 0; m < MAXW; ++m)
          if (m == slot) mine = (alive[m] >> (i & 31)) & 1u;
      }
      if (__syncthreads_or(mine)) {
#pragma unroll
        for (int m = 0; m < MAXW; ++m) alive[m] &= ~rows[r][m];
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

}  // namespace

// sup: (batch, n, n) bool; alive_in, alive_out: (batch, n) bool; nkeep:
// (batch,) int64; scratch: batch * n * ceil(n / 32) uint32 words.
// Returns 0 on success, a cudaError_t from the launches, or -3 for sizes
// the kernel does not take (n > 32 * 1024 * MAXW).
extern "C" int mxt_nms_sweep(const void* sup, const void* alive_in,
                             const void* nkeep, void* alive_out,
                             void* scratch, int batch, int n,
                             void* stream) {
  if (batch < 0 || n < 0) return -3;
  if (batch == 0 || n == 0) return 0;
  const int words = (n + 31) / 32;
  int threads = ((words + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if ((words + threads - 1) / threads > MAXW) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  const long long rows = static_cast<long long>(batch) * n;
  const long long packs = rows * words;
  const int pack_threads = 256;
  const long long pack_blocks = (packs + pack_threads - 1) / pack_threads;
  nms_pack_kernel<<<static_cast<unsigned>(pack_blocks), pack_threads, 0,
                    s>>>(static_cast<const uint8_t*>(sup), bits, rows, n,
                         words);
  nms_sweep_kernel<<<batch, threads, 0, s>>>(
      bits, static_cast<const uint8_t*>(alive_in),
      static_cast<const long long*>(nkeep),
      static_cast<uint8_t*>(alive_out), n, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mxt_nms_sweep_error_string(int code) {
  if (code == -3) return "bad sizes (n above 65536 or negative)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
