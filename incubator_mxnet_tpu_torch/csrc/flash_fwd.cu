// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs, in
// two builds: bf16 on the tensor cores (wgmma fed by TMA), fp32 on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (launched by `_flash_fwd`)
// in incubator_mxnet_tpu/ops/flash.py.  Same function: for each query row,
// softmax(scale * q . k^T) . v over the keys the mask keeps (causal:
// q_pos >= k_pos, top-left aligned; window > 0: also q_pos - k_pos <
// window), accumulated online over key tiles, plus the row's log-sum-exp
// `lse = m + log(l)` that the backward rebuilds P from.
//
// What bounds it on the card.  At the train shape (BH=128, L=1024, D=64,
// causal, 67.2 M kept pairs) it does 4*D flops per kept pair, 17.2 GFLOP,
// against q, k, v and o: 67.6 MB in bf16, 134 MB in fp32.  bf16: 0.0202 ms
// of memory traffic at 3.35 TB/s against 0.0174 ms at the dense bf16
// tensor-core rate (989 TFLOP/s), so the bytes bound it.  fp32: 0.26 ms at
// the 67 TFLOP/s CUDA-core rate against 0.04 ms of traffic, so the math
// does.
//
// bf16 (flash_fwd_tc_kernel): a block is one warpgroup (128 threads) per
// (bh, 64-row query tile).  Its thread 0 loads the q tile once by TMA
// and streams the band's k and v tiles through a ring of STAGES buffers
// guarded by mbarriers, so tile t+1 loads while tile t is computed (the
// ring, barriers, descriptors and tensor maps are csrc/hopper_tc.cuh's).
// Per key tile:
//   s = q . k^T       wgmma m64n64k16, both operands K-major from shared
//                     memory, fp32 accumulators; the scale (times log2 e)
//                     is applied to the accumulator, as the backward does
//                     when it rebuilds P from lse
//   online softmax    on the accumulator fragment: the thread's rows are
//                     warp*16 + lane/4 and +8, their max taken across the
//                     4 lanes of a quad; masks only on tiles that the
//                     diagonal, the window edge or a ragged end crosses;
//                     l sums the fp32 p
//   o += P . v        P rounded in place to packed bf16 as the A fragment
//                     of wgmma (registers), v read MN-major from the ring;
//                     o stays fp32 in registers, rescaled by alpha per row
// The one numeric change from the fp32 recipe is P rounded to bf16 before
// the P . v product.  Every sum stays fp32, and o is rounded to bf16 once,
// at the end.  The design moves each k and v tile from device memory once
// per query tile, and keeps s and P out of shared memory.
//
// fp32 (flash_fwd_kernel): every operand of the two products sits in
// shared memory, each K/V tile is streamed from device memory once per
// 64-row query tile, and the FMA units are fed from 128-bit
// shared-memory loads (rows padded by 4 floats, so the loads are free of
// bank conflicts) at 16 FMAs per loaded vector pair.  fp32 keeps its full
// precision (TF32 would not).
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
// all contiguous, bf16 ones 16-byte aligned (TMA).  The kernels allocate
// nothing and run on the caller's stream; the C entry point returns a
// cudaError_t (or a negative code for arguments it does not take).

#include "hopper_tc.cuh"

namespace {

// ------------------------------------------------ fp32: the CUDA cores

constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PS = BK + 4;    // padded row of the P tile

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


// ------------------------------------------------ bf16: wgmma fed by TMA

constexpr float LN2 = 0.6931471805599453f;

// Byte offsets of the kernel's shared memory from a 1024-aligned base:
// the resident q tile, the ring of (k, v) tile pairs and the barriers
// (full[STAGES], empty[STAGES], resident).
template <int D>
struct FwdSmem {
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int RING = T;
  static constexpr int BARS = RING + STAGES * 2 * T;
  static constexpr size_t bytes = BARS + (2 * STAGES + 1) * 8 + 1024;
};

// Max and sum over the 4 lanes of a quad: the lanes that hold one row of
// the accumulator fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block (one warpgroup) per (bh, query tile).  The thread owns query
// rows r0 = warp*16 + lane/4 and r0 + 8: its running max m (log2 units,
// scale applied), its share of the row sum l (summed across the quad at
// the end) and its columns of o.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, D < 128 ? 3 : 2)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int bh_count, int lq, int lk, int causal, int window,
                    float scale) {
  using L = Tile<D>;
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base;
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

  // thread 0 issues every load: the q tile once, and each (k, v) pair
  // into its ring stage once the stage is free
  auto load = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(full(s), 2 * L::BYTES);
    tma_tile<D>(ring_k(s), mk, (kt0 + i) * BK, bh, full(s));
    tma_tile<D>(ring_k(s) + L::BYTES, mv, (kt0 + i) * BK, bh, full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, L::BYTES);
    tma_tile<D>(sq, mq, q0, bh, resident);
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
    float sc[32];
    wg_fence();
    score_tc<D>(sc, sq, sk);  // s = q k^T
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);

    // scale (log2 units) and mask; the tile's row max
    const bool edge = !interior(q0, k0, lq, lk, causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      float t = sc[e] * sl2;
      if (edge) {
        const int qp = q0 + r0 + 8 * h;
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (!kept(qp, kp, lq, lk, causal, window)) t = -INFINITY;
      }
      sc[e] = t;
      mx[h] = fmaxf(mx[h], t);
    }
    // the online-softmax update of (m, l, o)
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      // all masked so far: weights stay 0 instead of exp(-inf + inf)
      mu[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    uint32_t a[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int h = r & 1;
      const float p0 = exp2f(sc[2 * r] - mu[h]);
      const float p1 = exp2f(sc[2 * r + 1] - mu[h]);
      l[h] += p0 + p1;
      a[r] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < L::W / 2; ++j) acc[c][j] *= alpha[(j >> 1) & 1];
    wg_fence();
    accumulate_tc<D>(acc, a, sv);  // o += p v
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

  // o = acc / l and lse = m + log(l), in natural units; a row no key
  // reached gets o = 0 and lse = -inf
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    inv[h] = lt > 0.f ? 1.f / lt : 0.f;
    const int qp = q0 + r0 + 8 * h;
    if ((lane & 3) == 0 && qp < lq)
      lse[(size_t)bh * lq + qp] =
          lt > 0.f ? (m[h] + log2f(lt)) * LN2 : -INFINITY;
  }
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int j = 0; j < L::W / 2; ++j) acc[c][j] *= inv[(j >> 1) & 1];
  store_rows<D>(acc, o + ((size_t)bh * lq + q0) * D, r0, lq - q0, lane);
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int bh, int lq, int lk, int causal, int window,
              float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = tile_map<D>(&mq, q, bh, lq)) ||
      (rc = tile_map<D>(&mk, k, bh, lk)) ||
      (rc = tile_map<D>(&mv, v, bh, lk)))
    return rc;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((lq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_tc_kernel<D><<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, bh, lq, lk, causal,
      window, scale);
  return cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 float* lse, int bh, int lq, int lk, int d, int causal,
                 int window, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<float, 32>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 64: return launch<float, 64>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 128: return launch<float, 128>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    default: return -2;
  }
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int lq, int lk, int d, int causal,
                  int window, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 64: return launch_tc<64>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    default: return -2;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t
// from the launch, or -1 (dtype) / -2 (head dim) / -3 (sizes) for
// arguments the kernel does not take, -4 / -5 when the driver cannot
// describe a bf16 operand to TMA.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int lq, int lk,
                             int d, int dtype, int causal, int window,
                             float scale, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || window < 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return dispatch_f32(q, k, v, o, l, bh, lq, lk, d, causal, window, scale, s);
    case 1: return dispatch_bf16(q, k, v, o, l, bh, lq, lk, d, causal, window, scale, s);
    default: return -1;
  }
}

extern "C" const char* mxt_error_string(int code) {
  switch (code) {
    case -1: return "unsupported dtype";
    case -2: return "unsupported head dim";
    case -3: return "bad sizes";
    case -4: return "cuTensorMapEncodeTiled refused an operand";
    case -5: return "the driver has no cuTensorMapEncodeTiled";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
