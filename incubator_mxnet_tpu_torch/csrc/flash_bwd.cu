// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: two
// kernels, flash_dq and flash_dkv.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` (both
// launched by `_flash_bwd`) in incubator_mxnet_tpu/ops/flash.py.  Same
// function, the FlashAttention backward recipe: each (query, key) tile of
// P is rebuilt from q, k and the forward's log-sum-exp, never stored in
// device memory:
//   s  = (q . k^T) * scale          (masked: p = 0 exactly)
//   p  = exp(s - lse)
//   dp = g . v^T
//   ds = p * (dp - delta) * scale    with delta = rowsum(g * o), computed
//                                    by the caller with plain torch ops
//   dq = sum over keys of ds . k                 (flash_dq)
//   dv = sum over queries of p^T . g             (flash_dkv)
//   dk = sum over queries of ds^T . q            (flash_dkv)
//
// What bounds it on the card: the math.  At the training shape (BH=128,
// L=1024, D=64, causal, 67.2 M kept pairs) flash_dq does 6*D flops per
// kept pair (s, dp, dq: 25.8 GFLOP) and flash_dkv 8*D (s, dp, dv, dk:
// 34.4 GFLOP), against about 85 and 102 MB of operands in bf16; in fp32
// on the CUDA cores that is ~0.39 and ~0.51 ms of operations and ~0.05 ms
// of memory traffic.  The design is the forward's (csrc/flash_fwd.cu):
// every operand of the products sits in shared memory, rows padded by 4
// floats so the 128-bit loads that feed the FMA units are free of bank
// conflicts, and each thread owns a 4 x 4 block of the score tile and
// 4 rows of its output.  The two score products run in separate loops so
// that fewer operands are live in registers at once.  bf16 is widened to
// fp32 on load and everything accumulates in fp32: right first; wgmma,
// TMA and tensor cores are later work.
//
// What differs from the TPU kernels:
// - The Pallas grids are sequential and carry the dq (dk, dv) sums across
//   grid steps in VMEM scratch.  CUDA blocks run in any order, so one
//   block owns a (bh, 64-row query tile) for dq and a (bh, 64-row key
//   tile) for dk/dv, loops over the other side's tiles, and keeps its sums
//   in registers.  Each block writes only its own rows: no atomics, and
//   the result does not depend on the order blocks run in.
// - The loops visit only tiles that hold a kept pair: flash_dq walks the
//   forward's key range (window start to causal diagonal), flash_dkv the
//   query tiles from the causal diagonal to the end of the window band
//   (the Python twin is `_q_tile_range` in ops/flash.py).  With causal and
//   Lk > Lq a key tile past the last query visits no query tile and writes
//   zeros.
// - Any L is covered: padded query rows (past Lq) are loaded as zeros and
//   masked, so they add nothing to dk/dv, and their lse/delta are never
//   read; padded keys (past Lk) are masked, so they add nothing to dq.
// - lse and delta are (BH, Lq) fp32, without the TPU's 8-lane padding.
// - Shared memory: flash_dkv holds k, v, q and g tiles and the p and ds
//   tiles, 170 KB at D=128, past the 48 KB static limit, so both kernels
//   take dynamic shared memory after cudaFuncSetAttribute.
//
// Layout: q, g and dq (BH, Lq, D); k, v, dk and dv (BH, Lk, D); lse and
// delta (BH, Lq) fp32; all contiguous.  The kernels allocate nothing and
// run on the caller's stream; the C entry points return a cudaError_t (or
// a negative code for arguments they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PS = 64 + 4;    // padded row of a (64 x 64) score tile

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

template <int D>
struct Smem {
  static constexpr int DP = D + 4;  // padded row of an operand tile
  // flash_dq: q, g, k, v tiles and the ds tile
  static constexpr size_t dq_bytes =
      (4 * 64 * DP + BQ * PS) * sizeof(float);
  // flash_dkv: k, v, q, g tiles, the p and ds tiles, lse and delta
  static constexpr size_t dkv_bytes =
      (4 * 64 * DP + 2 * BK * PS + 2 * BQ) * sizeof(float);
};

// acc[r][*] += sum over 64 score columns of A[row r][j] * B[j][*], where
// A is a (64 x PS) score tile in shared memory (this thread's rows
// ty*4 .. ty*4+3) and B a (64 x DP) operand tile; the thread owns output
// columns (c*16 + tx)*VW .. +VW-1.
template <int D>
__device__ __forceinline__ void accumulate_rows(
    float (&acc)[4][D / 16], const float* A, const float* B, int ty,
    int tx) {
  constexpr int DP = Smem<D>::DP;
  constexpr int VW = D >= 64 ? 4 : 2;
  constexpr int NV = D / (16 * VW);
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) lds<4>(a[r], &A[(ty * 4 + r) * PS + j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float b[VW];
        lds<VW>(b, &B[(j + e) * DP + (c * 16 + tx) * VW]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            acc[r][c * VW + w] = fmaf(a[r][e], b[w], acc[r][c * VW + w]);
      }
    }
  }
}

// s[r][j] = sum_d A[ty*4 + r][d] * B[tx + 16*j][d] over two (64 x DP)
// operand tiles in shared memory.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const float* A,
                                           const float* B, int ty, int tx) {
  constexpr int DP = Smem<D>::DP;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) lds<4>(a[r], &A[(ty * 4 + r) * DP + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) lds<4>(b[j], &B[(tx + 16 * j) * DP + d]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[r][j] = fmaf(a[r][e], b[j][e], s[r][j]);
  }
}

// Rows [0, 64) of a (rows, D) matrix into a (64 x DP) fp32 tile; rows at
// or past `valid` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int valid, int tid) {
  constexpr int DP = Smem<D>::DP;
  for (int i = tid; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = r < valid ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

__device__ __forceinline__ bool kept(int qp, int kp, int lq, int lk,
                                     int causal, int window) {
  bool keep = qp < lq && kp < lk;
  if (causal) {
    keep = keep && qp >= kp;
    if (window > 0) keep = keep && qp - kp < window;
  }
  return keep;
}

// One block per (bh, query tile); each thread owns 4 query rows
// (ty*4 .. ty*4+3), key columns tx + 16*j of the score tile, and output
// columns (c*16 + tx)*VW .. of dq.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int bh_count, int lq, int lk, int causal, int window,
                float scale) {
  constexpr int DP = Smem<D>::DP;
  constexpr int VW = D >= 64 ? 4 : 2;
  constexpr int NV = D / (16 * VW);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* Gs = Qs + BQ * DP;                      // [BQ][DP]
  float* Ks = Gs + BQ * DP;                      // [BK][DP]
  float* Vs = Ks + BK * DP;                      // [BK][DP]
  float* Ss = Vs + BK * DP;                      // [BQ][PS], ds

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (lq + BQ - 1) / BQ;
  // the longest causal rows are scheduled first
  const int iq = nq - 1 - blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = iq * BQ;
  const size_t qbase = ((size_t)bh * lq + q0) * D;
  const size_t kbase = (size_t)bh * lk * D;

  load_tile<T, D>(Qs, q + qbase, lq - q0, tid);
  load_tile<T, D>(Gs, g + qbase, lq - q0, tid);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    const bool in = qp < lq;  // padded rows: never read past Lq
    lse_r[r] = in ? lse[(size_t)bh * lq + qp] : 0.f;
    delta_r[r] = in ? delta[(size_t)bh * lq + qp] : 0.f;
  }

  // key tiles [kt0, kt1) hold every kept pair of this query tile
  const int nk = (lk + BK - 1) / BK;
  int kt0 = 0, kt1 = nk;
  if (causal) {
    kt1 = min(nk, (min(q0 + BQ, lq) - 1) / BK + 1);
    if (window > 0) kt0 = max(0, q0 - window + 1) / BK;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K and ds are consumed
    load_tile<T, D>(Ks, k + kbase + (size_t)k0 * D, lk - k0, tid);
    load_tile<T, D>(Vs, v + kbase + (size_t)k0 * D, lk - k0, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile<D>(s, Qs, Ks, ty, tx);
    score_tile<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = kept(qp, kp, lq, lk, causal, window)
                            ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        Ss[(ty * 4 + r) * PS + tx + 16 * j] =
            p * (dp[r][j] - delta_r[r]) * scale;
      }
    }
    __syncthreads();
    accumulate_rows<D>(acc, Ss, Ks, ty, tx);  // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= lq) continue;
    T* row = dq + ((size_t)bh * lq + qp) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        row[(c * 16 + tx) * VW + w] = from_f<T>(acc[r][c * VW + w]);
  }
}

// One block per (bh, key tile); each thread owns 4 key rows
// (ty*4 .. ty*4+3), query columns tx + 16*j of the transposed score tile,
// and output columns (c*16 + tx)*VW .. of dk and dv.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int bh_count, int lq, int lk,
                 int causal, int window, float scale) {
  constexpr int DP = Smem<D>::DP;
  constexpr int VW = D >= 64 ? 4 : 2;
  constexpr int NV = D / (16 * VW);
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][DP]
  float* Vs = Ks + BK * DP;                      // [BK][DP]
  float* Qs = Vs + BK * DP;                      // [BQ][DP]
  float* Gs = Qs + BQ * DP;                      // [BQ][DP]
  float* Ps = Gs + BQ * DP;                      // [BK][PS], p^T
  float* Ss = Ps + BK * PS;                      // [BK][PS], ds^T
  float* Ls = Ss + BK * PS;                      // [BQ], lse
  float* Ds = Ls + BQ;                           // [BQ], delta

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the first key tiles see the most query tiles: scheduled first
  const int jk = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int k0 = jk * BK;
  const size_t kbase = ((size_t)bh * lk + k0) * D;
  const size_t qbase = (size_t)bh * lq * D;

  load_tile<T, D>(Ks, k + kbase, lk - k0, tid);
  load_tile<T, D>(Vs, v + kbase, lk - k0, tid);

  // query tiles [it0, it1) hold every kept pair of this key tile: from
  // the causal diagonal to the end of the window band
  const int nq = (lq + BQ - 1) / BQ;
  int it0 = 0, it1 = nq;
  if (causal) {
    it0 = min(nq, k0 / BQ);
    if (window > 0)
      it1 = min(nq, (min(k0 + BK, lk) - 1 + window - 1) / BQ + 1);
  }

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int it = it0; it < it1; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile's Q, g, p and ds are consumed
    load_tile<T, D>(Qs, q + qbase + (size_t)q0 * D, lq - q0, tid);
    load_tile<T, D>(Gs, g + qbase + (size_t)q0 * D, lq - q0, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < lq;  // padded rows: never read past Lq
      Ls[tid] = in ? lse[(size_t)bh * lq + q0 + tid] : 0.f;
      Ds[tid] = in ? delta[(size_t)bh * lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile<D>(s, Ks, Qs, ty, tx);   // s^T
    score_tile<D>(dp, Vs, Gs, ty, tx);  // dp^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kp = k0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float p = kept(q0 + qc, kp, lq, lk, causal, window)
                            ? expf(s[r][j] * scale - Ls[qc]) : 0.f;
        Ps[(ty * 4 + r) * PS + qc] = p;
        Ss[(ty * 4 + r) * PS + qc] = p * (dp[r][j] - Ds[qc]) * scale;
      }
    }
    __syncthreads();
    accumulate_rows<D>(acc_v, Ps, Gs, ty, tx);  // dv += p^T g
    accumulate_rows<D>(acc_k, Ss, Qs, ty, tx);  // dk += ds^T q
  }

  // every row of the tile is written, zeros where no query reached it
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= lk) continue;
    T* krow = dk + ((size_t)bh * lk + kp) * D;
    T* vrow = dv + ((size_t)bh * lk + kp) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        const int col = (c * 16 + tx) * VW + w;
        krow[col] = from_f<T>(acc_k[r][c * VW + w]);
        vrow[col] = from_f<T>(acc_v[r][c * VW + w]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, lq, lk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, long long tiles, int bh,
                    unsigned* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n = tiles * bh;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = Smem<D>::dq_bytes;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dq_kernel<T, D>, smem,
                            (a.lq + BQ - 1) / BQ, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, D><<<blocks, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, static_cast<T*>(a.dq), a.bh, a.lq, a.lk, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = Smem<D>::dkv_bytes;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dkv_kernel<T, D>, smem,
                            (a.lk + BK - 1) / BK, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, D><<<blocks, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bh, a.lq,
      a.lk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// which = 0: flash_dq, 1: flash_dkv
template <typename T>
int dispatch_d(int which, int d, const Args& a) {
  switch (d) {
    case 32: return which ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return which ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return which ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return -2;
  }
}

int dispatch(int which, int d, int dtype, const Args& a) {
  if (a.bh < 1 || a.lq < 1 || a.lk < 1 || a.window < 0) return -3;
  switch (dtype) {
    case 0: return dispatch_d<float>(which, d, a);
    case 1: return dispatch_d<__nv_bfloat16>(which, d, a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns 0 on success, a
// cudaError_t from the launch, or -1 (dtype) / -2 (head dim) / -3 (sizes)
// for arguments the kernel does not take.
extern "C" int mxt_flash_dq(const void* q, const void* k, const void* v,
                            const void* g, const void* lse,
                            const void* delta, void* dq, int bh, int lq,
                            int lk, int d, int dtype, int causal,
                            int window, float scale, void* stream) {
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, bh, lq,
         lk, causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(0, d, dtype, a);
}

extern "C" int mxt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int lq, int lk, int d, int dtype, int causal,
                             int window, float scale, void* stream) {
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv, bh, lq, lk,
         causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(1, d, dtype, a);
}

extern "C" const char* mxt_flash_bwd_error_string(int code) {
  switch (code) {
    case -1: return "unsupported dtype";
    case -2: return "unsupported head dim";
    case -3: return "bad sizes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
