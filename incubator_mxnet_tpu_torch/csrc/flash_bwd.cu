// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: two
// kernels, flash_dq and flash_dkv, each in two builds: bf16 on the tensor
// cores (wgmma fed by TMA), fp32 on the CUDA cores.
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
// 34.4 GFLOP), against about 85 and 102 MB of operands in bf16: 0.026
// and 0.035 ms at the dense bf16 tensor-core rate, ~0.05 ms of memory
// traffic.
//
// bf16 (flash_dq_tc_kernel, flash_dkv_tc_kernel): a block is one
// warpgroup (128 threads), which issues every product as wgmma m64nNk16
// (bf16 operands, fp32 accumulators in registers); its thread 0 also
// issues the TMA loads.  The block's own 64-row tiles (q and g for dq, k
// and v for dk/dv) are loaded once; the other side's tiles stream through
// a ring of STAGES buffers guarded by mbarriers, so tile t+1 loads while
// tile t is computed.  There is no separate producer warp: with one
// (160 threads a block), flash_dkv at D=64 spilled under a two-blocks-an-
// SM bound and ran one block an SM without it; with 128 threads it takes
// 176 registers, no spills, two blocks an SM.  Operands stay bf16 in
// shared memory, in the 128-byte swizzle that TMA writes and wgmma's
// descriptors read (64-byte at D=32; D=128 is two 64-column chunks).
// The score products (s, dp) read both
// operands from shared memory, K-major; the gradient products take P and
// dS straight from the score accumulators: the fp32 accumulator of
// m64n64k16 already has the register layout of wgmma's A operand, so
// each pair is rounded to packed bf16 in place and B (the streamed or
// resident tile, d contiguous) is read MN-major.  That rounding of P and
// dS is the one numeric change from the fp32 recipe; every sum stays
// fp32 and dq/dk/dv are rounded to bf16 once, at the end.  Masks work on
// the accumulator fragment (row warp*16 + lane/4 (+8), column 8*j +
// 2*(lane%4) (+1)) and only on tiles that the diagonal, the window edge
// or a ragged end crosses.  lse and delta come per row from device
// memory (dq) or per column with each query tile by TMA (dk/dv).
// Tensor maps are 3-D (BH, L, D) with 64-row boxes, so rows past L
// inside a head are zero-filled; they are encoded on the host at each
// call and passed as __grid_constant__ parameters.  These pieces (ring,
// barriers, descriptors, the wgmma wrappers, tensor maps) are shared with
// the bf16 forward in csrc/hopper_tc.cuh.
//
// fp32 (flash_dq_kernel, flash_dkv_kernel): on the CUDA cores, in full
// fp32.  One TF32 product per product cannot meet the fp32 check;
// split-TF32 (three tf32 products, as flash_fwd_tf32_kernel in
// csrc/flash_fwd.cu does) can, and is these kernels' next redesign.
// Every operand of the products sits in shared memory, rows padded by 4 floats so the 128-bit loads that feed
// the FMA units are free of bank conflicts, and each thread owns a 4 x 4
// block of the score tile and 4 rows of its output.  The two score
// products run in separate loops so that fewer operands are live in
// registers at once.
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
//   masked, so they add nothing to dk/dv; padded keys (past Lk) are
//   masked, so they add nothing to dq.
// - lse and delta are (BH, Lq) fp32, without the TPU's 8-lane padding.
// - Shared memory: the fp32 flash_dkv holds k, v, q and g tiles and the p
//   and ds tiles, 170 KB at D=128, past the 48 KB static limit, so every
//   kernel takes dynamic shared memory after cudaFuncSetAttribute.
//
// Layout: q, g and dq (BH, Lq, D); k, v, dk and dv (BH, Lk, D); lse and
// delta (BH, Lq) fp32; all contiguous, bf16 ones 16-byte aligned (TMA).
// The kernels allocate nothing and run on the caller's stream; the C
// entry points return a cudaError_t (or a negative code for arguments
// they do not take).

#include "hopper_tc.cuh"

namespace {

constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PS = 64 + 4;    // padded row of a (64 x 64) score tile

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ------------------------------------------------ bf16: wgmma fed by TMA

// Byte offsets of the two kernels' shared memory from a 1024-aligned
// base: the block's own two tiles, the ring, lse/delta slices (dkv) and
// the barriers (full[STAGES], empty[STAGES], resident).
template <int D>
struct TcSmem {
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int RING = 2 * T;                          // own tiles
  static constexpr int ROWS = RING + STAGES * 2 * T;          // lse, delta
  static constexpr int BARS = ROWS + STAGES * 2 * BQ * 4;
  static constexpr size_t bytes = BARS + (2 * STAGES + 1) * 8 + 1024;
};

// One block (one warpgroup) per (bh, query tile).  The thread owns query
// rows r0 = warp*16 + lane/4 and r0 + 8.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, D < 128 ? 3 : 2)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mg,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int bh_count, int lq,
                   int lk, int causal, int window, float scale) {
  using L = Tile<D>;
  using S = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sg = base + L::BYTES;
  const uint32_t bars = base + S::BARS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t resident = bars + 8 * 2 * STAGES;
  auto ring_k = [&](int s) { return base + S::RING + s * 2 * L::BYTES; };

  const int nq = (lq + BQ - 1) / BQ;
  // the longest causal rows are scheduled first
  const int iq = nq - 1 - blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = iq * BQ;
  // key tiles [kt0, kt1) hold every kept pair of this query tile
  const int nk = (lk + BK - 1) / BK;
  int kt0 = 0, kt1 = nk;
  if (causal) {
    kt1 = min(nk, (min(q0 + BQ, lq) - 1) / BK + 1);
    if (window > 0) kt0 = max(0, q0 - window + 1) / BK;
  }
  const int n = kt1 - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: the block's own tiles once, and each
  // streamed tile into its ring stage once the stage is free
  auto load = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(full(s), 2 * L::BYTES);
    tma_tile<D>(ring_k(s), mk, (kt0 + i) * BK, bh, full(s));
    tma_tile<D>(ring_k(s) + L::BYTES, mv, (kt0 + i) * BK, bh, full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, 2 * L::BYTES);
    tma_tile<D>(sq, mq, q0, bh, resident);
    tma_tile<D>(sg, mg, q0, bh, resident);
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    const bool in = qp < lq;  // padded rows: never read past Lq
    lse2[h] = in ? lse[(size_t)bh * lq + qp] * LOG2E : 0.f;
    dl[h] = in ? delta[(size_t)bh * lq + qp] : 0.f;
  }
  float acc[L::CHUNKS][L::W / 2];
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < L::W / 2; ++i) acc[c][i] = 0.f;

  if (n > 0) mbar_wait(resident, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt0 + i) * BK;
    const uint32_t sk = ring_k(s), sv = sk + L::BYTES;
    mbar_wait(full(s), (i / STAGES) & 1);
    float sc[32], dp[32];
    wg_fence();
    score_tc<D>(sc, sq, sk);  // s = q k^T
    wg_commit();
    score_tc<D>(dp, sg, sv);  // dp = g v^T
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    const bool edge = !interior(q0, k0, lq, lk, causal, window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      float p = exp2f(fmaf(sc[e], sl2, -lse2[h]));
      if (edge) {
        const int qp = q0 + r0 + 8 * h;
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (!kept(qp, kp, lq, lk, causal, window)) p = 0.f;
      }
      sc[e] = p;
    }
    wg_wait<0>();
    reg_fence(dp);
    uint32_t a[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int h = r & 1;
      a[r] = pack_bf16(sc[2 * r] * (dp[2 * r] - dl[h]) * scale,
                       sc[2 * r + 1] * (dp[2 * r + 1] - dl[h]) * scale);
    }
    wg_fence();
    accumulate_tc<D>(acc, a, sk);  // dq += ds k
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) reg_fence(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_wait(empty(s), (i / STAGES) & 1);
      load(i + STAGES);
    }
  }
  store_rows<D>(acc, dq + ((size_t)bh * lq + q0) * D, r0, lq - q0, lane);
}

// One block (one warpgroup) per (bh, key tile).  The thread owns key rows
// r0 = warp*16 + lane/4 and r0 + 8 of the transposed score tiles and of
// dk and dv.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mg,
                    const __grid_constant__ CUtensorMap mlse,
                    const __grid_constant__ CUtensorMap mdelta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int bh_count, int lq,
                    int lk, int causal, int window, float scale) {
  using L = Tile<D>;
  using S = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows_f =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + S::ROWS);
  const uint32_t sk = base, sv = base + L::BYTES;
  const uint32_t bars = base + S::BARS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t resident = bars + 8 * 2 * STAGES;
  auto ring_q = [&](int s) { return base + S::RING + s * 2 * L::BYTES; };
  // lse of stage s at rows_f[s * 2 * BQ], delta right after it
  auto ring_rows = [&](int s) { return base + S::ROWS + s * 2 * BQ * 4; };

  // the first key tiles see the most query tiles: scheduled first
  const int jk = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int k0 = jk * BK;
  // query tiles [it0, it1) hold every kept pair of this key tile: from
  // the causal diagonal to the end of the window band
  const int nq = (lq + BQ - 1) / BQ;
  int it0 = 0, it1 = nq;
  if (causal) {
    it0 = min(nq, k0 / BQ);
    if (window > 0)
      it1 = min(nq, (min(k0 + BK, lk) - 1 + window - 1) / BQ + 1);
  }
  const int n = it1 - it0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: the block's own tiles once, and each
  // streamed tile with its lse and delta into its ring stage once the
  // stage is free
  auto load = [&](int i) {
    const int s = i % STAGES;
    const int q0 = (it0 + i) * BQ;
    mbar_expect_tx(full(s), 2 * L::BYTES + 2 * BQ * 4);
    tma_tile<D>(ring_q(s), mq, q0, bh, full(s));
    tma_tile<D>(ring_q(s) + L::BYTES, mg, q0, bh, full(s));
    // rows past Lq read the next head's values (or zeros past the end):
    // their pairs are masked
    tma_row(ring_rows(s), mlse, bh * lq + q0, full(s));
    tma_row(ring_rows(s) + BQ * 4, mdelta, bh * lq + q0, full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, 2 * L::BYTES);
    tma_tile<D>(sk, mk, k0, bh, resident);
    tma_tile<D>(sv, mv, k0, bh, resident);
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float acc_k[L::CHUNKS][L::W / 2], acc_v[L::CHUNKS][L::W / 2];
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < L::W / 2; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  if (n > 0) mbar_wait(resident, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int q0 = (it0 + i) * BQ;
    const uint32_t sq = ring_q(s), sg = sq + L::BYTES;
    const float* lse_s = rows_f + s * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    mbar_wait(full(s), (i / STAGES) & 1);
    float st[32], dpt[32];
    wg_fence();
    score_tc<D>(st, sk, sq);  // s^T = k q^T
    wg_commit();
    score_tc<D>(dpt, sv, sg);  // dp^T = v g^T
    wg_commit();
    wg_wait<1>();
    reg_fence(st);
    const bool edge = !interior(q0, k0, lq, lk, causal, window);
    uint32_t a[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        float p = exp2f(fmaf(st[idx], sl2, -(e & 1 ? l2.y : l2.x) * LOG2E));
        if (edge) {
          const int kp = k0 + r0 + 8 * (e >> 1);
          if (!kept(q0 + qc + (e & 1), kp, lq, lk, causal, window)) p = 0.f;
        }
        st[idx] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) a[r] = pack_bf16(st[2 * r], st[2 * r + 1]);
    wg_fence();
    accumulate_tc<D>(acc_v, a, sg);  // dv += p^T g
    wg_commit();
    wg_wait<1>();
    reg_fence(dpt);
    uint32_t b[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * (lane & 3));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * j + 2 * h;
        b[2 * j + h] = pack_bf16(st[idx] * (dpt[idx] - d2.x) * scale,
                                 st[idx + 1] * (dpt[idx + 1] - d2.y) * scale);
      }
    }
    wg_fence();
    accumulate_tc<D>(acc_k, b, sq);  // dk += ds^T q
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      reg_fence(acc_k[c]);
      reg_fence(acc_v[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_wait(empty(s), (i / STAGES) & 1);
      load(i + STAGES);
    }
  }
  // every row of the tile is written, zeros where no query reached it
  store_rows<D>(acc_k, dk + ((size_t)bh * lk + k0) * D, r0, lk - k0, lane);
  store_rows<D>(acc_v, dv + ((size_t)bh * lk + k0) * D, r0, lk - k0, lane);
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

template <int D>
int launch_dq_tc(const Args& a) {
  CUtensorMap mq, mk, mv, mg;
  int rc;
  if ((rc = tile_map<D>(&mq, a.q, a.bh, a.lq)) ||
      (rc = tile_map<D>(&mk, a.k, a.bh, a.lk)) ||
      (rc = tile_map<D>(&mv, a.v, a.bh, a.lk)) ||
      (rc = tile_map<D>(&mg, a.g, a.bh, a.lq)))
    return rc;
  const size_t smem = TcSmem<D>::bytes;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dq_tc_kernel<D>, smem,
                            (a.lq + BQ - 1) / BQ, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dq_tc_kernel<D><<<blocks, TC_THREADS, smem, a.stream>>>(
      mq, mk, mv, mg, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.bh, a.lq, a.lk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_tc(const Args& a) {
  CUtensorMap mq, mk, mv, mg, mlse, mdelta;
  const long long rows = (long long)a.bh * a.lq;
  if (rows > 0x7fffffffLL) return -3;  // TMA coordinates are 32-bit
  int rc;
  if ((rc = tile_map<D>(&mq, a.q, a.bh, a.lq)) ||
      (rc = tile_map<D>(&mk, a.k, a.bh, a.lk)) ||
      (rc = tile_map<D>(&mv, a.v, a.bh, a.lk)) ||
      (rc = tile_map<D>(&mg, a.g, a.bh, a.lq)) ||
      (rc = row_map(&mlse, a.lse, rows)) ||
      (rc = row_map(&mdelta, a.delta, rows)))
    return rc;
  const size_t smem = TcSmem<D>::bytes;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dkv_tc_kernel<D>, smem,
                            (a.lk + BK - 1) / BK, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dkv_tc_kernel<D><<<blocks, TC_THREADS, smem, a.stream>>>(
      mq, mk, mv, mg, mlse, mdelta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.bh, a.lq, a.lk, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

// which = 0: flash_dq, 1: flash_dkv
int dispatch_f32(int which, int d, const Args& a) {
  switch (d) {
    case 32: return which ? launch_dkv<float, 32>(a) : launch_dq<float, 32>(a);
    case 64: return which ? launch_dkv<float, 64>(a) : launch_dq<float, 64>(a);
    case 128:
      return which ? launch_dkv<float, 128>(a) : launch_dq<float, 128>(a);
    default: return -2;
  }
}

int dispatch_bf16(int which, int d, const Args& a) {
  switch (d) {
    case 32: return which ? launch_dkv_tc<32>(a) : launch_dq_tc<32>(a);
    case 64: return which ? launch_dkv_tc<64>(a) : launch_dq_tc<64>(a);
    case 128: return which ? launch_dkv_tc<128>(a) : launch_dq_tc<128>(a);
    default: return -2;
  }
}

int dispatch(int which, int d, int dtype, const Args& a) {
  if (a.bh < 1 || a.lq < 1 || a.lk < 1 || a.window < 0) return -3;
  switch (dtype) {
    case 0: return dispatch_f32(which, d, a);
    case 1: return dispatch_bf16(which, d, a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns 0 on success, a
// cudaError_t from the launch, or -1 (dtype) / -2 (head dim) / -3 (sizes)
// for arguments the kernel does not take, -4 / -5 when the driver cannot
// describe a bf16 operand to TMA.
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
    case -4: return "cuTensorMapEncodeTiled refused an operand";
    case -5: return "the driver has no cuTensorMapEncodeTiled";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
