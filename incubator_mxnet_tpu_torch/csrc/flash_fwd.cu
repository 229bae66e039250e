// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (launched by `_flash_fwd`)
// in incubator_mxnet_tpu/ops/flash.py.  Same function: for each query row,
// softmax((q * scale) . k^T) . v over the keys the mask keeps (causal:
// q_pos >= k_pos, top-left aligned; window > 0: also q_pos - k_pos <
// window), accumulated online over key tiles, plus the row's log-sum-exp
// `lse = m + log(l)` that the backward rebuilds P from.
//
// What bounds it on the card: the math.  At the serving shape (BH=128,
// L=1024, D=64, causal) it does 4*BH*D*L^2/2 = 17.2 GFLOP against 134 MB
// of q/k/v/o; in fp32 that is ~0.26 ms at the 67 TFLOP/s non-tensor-core
// rate and ~0.04 ms of memory traffic.  The design therefore keeps every
// operand of the two products in shared memory, streams each K/V tile
// from device memory once per 64-row query tile, and feeds the FMA units
// from 128-bit shared-memory loads (rows padded by 4 floats, so the loads
// are free of bank conflicts) at 16 FMAs per loaded vector pair.  It
// accumulates in fp32 on the CUDA cores (bf16 is widened on load): simple
// and exact first; wgmma, TMA and warp specialisation are later work.
//
// What differs from the TPU kernel:
// - The Pallas grid is sequential and carries (m, l, acc) across grid
//   steps in VMEM scratch.  CUDA blocks run in any order, so one block
//   owns a (bh, 64-row query tile) and walks its key tiles in a loop; the
//   carry lives in registers.  Nothing carries between blocks.
// - The key loop visits only tiles that hold a kept pair: it starts at
//   the window's first tile and stops at the causal diagonal, so dead
//   tiles are never loaded (the TPU kernel steps through them).
// - Masked scores are -inf, not -1e30, and the running max is guarded, so
//   a row whose first tiles are fully masked gets weight 0 there (never
//   exp(0) = 1), and padded keys past L never reach the output.
// - Any L is covered: the ragged last tile is masked here, rows past Lq
//   are not written.  lse is (BH, Lq), without the TPU's 8-lane padding.
//
// Layout: q (BH, Lq, D), k and v (BH, Lk, D), o like q, lse (BH, Lq) fp32,
// all contiguous.  The kernel allocates nothing and runs on the caller's
// stream; the C entry point returns a cudaError_t (or a negative code for
// arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PS = BK + 4;    // padded row of the P tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// W consecutive floats from shared memory in one vector load.
template <int W>
__device__ __forceinline__ void lds(float (&dst)[W], const float* p);
template <>
__device__ __forceinline__ void lds<4>(float (&dst)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
}
template <>
__device__ __forceinline__ void lds<2>(float (&dst)[2], const float* p) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  dst[0] = t.x; dst[1] = t.y;
}

// Max and sum over the 16 lanes that share a row group (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
struct Smem {
  static constexpr int DP = D + 4;  // padded row of the Q and K tiles
  static constexpr size_t floats = 2 * BQ * DP + BK * D + BQ * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

// One block per (bh, query tile).  Each thread owns 4 query rows
// (ty*4 .. ty*4+3); for S = Q K^T it owns key columns tx + 16*j, and for
// O it owns output columns (c*16 + tx)*VW .. +VW-1.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int bh_count, int lq, int lk,
                 int causal, int window, float scale) {
  constexpr int DP = Smem<D>::DP;
  constexpr int VW = D >= 64 ? 4 : 2;     // output vector width
  constexpr int NV = D / (16 * VW);       // output vectors per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DP], scaled
  float* Ks = Qs + BQ * DP;                      // [BK][DP]
  float* Vs = Ks + BK * DP;                      // [BK][D]
  float* Ps = Vs + BK * D;                       // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (lq + BQ - 1) / BQ;
  // the longest causal rows are scheduled first
  const int iq = nq - 1 - blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = iq * BQ;
  const size_t qbase = (size_t)bh * lq * D;
  const size_t kbase = (size_t)bh * lk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = q0 + r < lq
        ? to_f(q[qbase + (size_t)(q0 + r) * D + c]) * scale : 0.f;
  }

  // key tiles [kt0, kt1) hold every kept pair of this query tile
  const int nk = (lk + BK - 1) / BK;
  int kt0 = 0, kt1 = nk;
  if (causal) {
    kt1 = min(nk, (min(q0 + BQ, lq) - 1) / BK + 1);
    if (window > 0) kt0 = max(0, q0 - window + 1) / BK;
  }

  float m[4], l[4], acc[4][NV * VW];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < lk;
      const size_t g = kbase + (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f(k[g]) : 0.f;
      Vs[r * D + c] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lds<4>(a[r], &Qs[(ty * 4 + r) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) lds<4>(b[j], &Ks[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[r][j] = fmaf(a[r][e], b[j][e], s[r][j]);
    }

    // mask, then the online-softmax update of (m, l, acc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = kp < lk;
        if (causal) {
          keep = keep && qp >= kp;
          if (window > 0) keep = keep && qp - kp < window;
        }
        if (!keep) s[r][j] = -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      // all masked so far: weights stay 0 instead of exp(-inf + inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_use);
        Ps[(ty * 4 + r) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[r] = l[r] * alpha + row_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // O += P V over this tile's keys, four keys per step
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lds<4>(p[r], &Ps[(ty * 4 + r) * PS + j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vv[VW];
          lds<VW>(vv, &Vs[(j + e) * D + (c * 16 + tx) * VW]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[r][c * VW + w] = fmaf(p[r][e], vv[w], acc[r][c * VW + w]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = o + qbase + (size_t)qp * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        orow[(c * 16 + tx) * VW + w] = from_f<T>(acc[r][c * VW + w] * inv);
    if (tx == 0)
      lse[(size_t)bh * lq + qp] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int lq, int lk, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((lq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, bh, lq, lk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int lq, int lk, int d, int causal,
               int window, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    default: return -2;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t
// from the launch, or -1 (dtype) / -2 (head dim) / -3 (sizes) for
// arguments the kernel does not take.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int lq, int lk,
                             int d, int dtype, int causal, int window,
                             float scale, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || window < 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, l, bh, lq, lk, d, causal, window, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, l, bh, lq, lk, d, causal, window, scale, s);
    default: return -1;
  }
}

extern "C" const char* mxt_error_string(int code) {
  switch (code) {
    case -1: return "unsupported dtype";
    case -2: return "unsupported head dim";
    case -3: return "bad sizes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
