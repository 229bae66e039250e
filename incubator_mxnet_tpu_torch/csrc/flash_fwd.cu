// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs, in
// two builds, both on the tensor cores (wgmma fed by TMA): bf16 as it
// is, fp32 as split-TF32 (three tf32 products per fp32 product).
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
// tensor-core rate (989 TFLOP/s), so the bytes bound it.  fp32: three
// tf32 products per product, 51.5 GFLOP at 495 TFLOP/s, 0.104 ms,
// against 0.040 ms of traffic, so the math does (on the CUDA cores, 67
// TFLOP/s, it would be 0.26 ms).
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
// fp32 (flash_fwd_tf32_kernel): the bf16 kernel's block, ring, schedule
// and online softmax, with every product split.  One tf32 product keeps
// 11 of fp32's 24 mantissa bits and cannot meet the fp32 check (5e-5,
// abs + rel).  Split-TF32 can: each operand x becomes hi + lo, hi = x
// with its low 13 bits cleared (tf32_hi) and lo = x - hi (exact), and a
// product a.b becomes lo_a.hi_b + hi_a.lo_b + hi_a.hi_b summed in fp32
// (lo.lo, 2^-22 of the product, is dropped; the tensor core keeps 11
// bits of lo, 2^-21).  So a tile takes 3 x D/8 wgmma m64nNk8 for s and
// 3 x BKT/8 per W-column chunk of o.  Where the design meets trouble:
// - tf32 operands in shared memory must be K-major: PTX has no transpose
//   flag for .tf32.  s = q . k^T is K-major as TMA lands q and k (rows
//   along D).  For o += P . v the B operand v is (keys, D): MN-major.
//   So after a (k, v) pair lands, the warpgroup writes v^T (D rows of
//   BKT keys) into two buffers of its own, hi and lo, in the same pass
//   (transpose_split, csrc/hopper_tc.cuh); its loads and stores are free
//   of bank conflicts.
// - The split.  hi is stored with its low bits cleared, not left for the
//   tensor core to ignore: PTX leaves the tf32 layout to the
//   implementation (cvt.rna.tf32 clears the bits), so this holds however
//   the hardware reads the low bits.  q and k are split in place (hi
//   over the landed tile, lo beside it), one float4 pass that needs no
//   swizzle arithmetic since both halves share the layout.
// - P as the A operand from registers.  The tf32 A fragment of m64k8
//   holds columns t and t + 4 (t = lane % 4) of rows r0 and r0 + 8; the
//   fp32 accumulator of s holds columns 2t and 2t + 1.  P . v sums over
//   keys, so v^T's positions are permuted inside each group of 8 (key
//   8j + 2t at position 8j + t, key 8j + 2t + 1 at 8j + t + 4), and the
//   score registers are A's words as they stand, split into hi and lo in
//   registers.  l sums the fp32 p.
// - Shared memory and occupancy.  Per block: q hi and lo, a 2-stage ring
//   of (k, v), k lo, v^T hi and lo.  BKT (keys per tile) is 64 at D=32
//   and 32 at D=64 and 128:
//     D=32,  BKT=64:  72 KB a block, 3 blocks an SM
//     D=64,  BKT=32:  88 KB a block, 2 blocks an SM (BKT=64: 144 KB, 1)
//     D=128, BKT=32: 176 KB a block, 1 block an SM (BKT=64 needs 288 KB)
//   Two blocks at D=64 let one block's softmax and splits overlap the
//   other's products.  The o accumulator is D/2 registers a thread, the
//   score tile BKT/2, P's fragments BKT; q stays in shared memory.
// - The ring stage is freed once s is done (v was transposed before), so
//   the next load overlaps the softmax and P . v.  Two barriers a tile:
//   before the splits (every warp is past the last tile's products, which
//   read k lo and v^T) and after them, behind a fence.proxy.async, since
//   wgmma reads shared memory through the async proxy.
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
// all contiguous and 16-byte aligned (TMA).  The kernels allocate
// nothing and run on the caller's stream; the C entry point returns a
// cudaError_t (or a negative code for arguments it does not take).

#include "hopper_tc.cuh"

namespace {

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

// ------------------------------------------------ fp32: split-TF32 wgmma

// Keys per tile of flash_fwd_tf32_kernel and the shared memory it needs
// (byte offsets from a 1024-aligned base): the q tile's hi (TMA-landed,
// split in place) and lo halves; a ring of STAGES (k, v) pairs as TMA
// lands them, k's hi split in place; k's lo; v^T's hi and lo; the
// barriers (full[STAGES], empty[STAGES], resident).
template <int D>
struct Tf32Fwd {
  static constexpr int BKT = D == 32 ? 64 : 32;
  static constexpr int Q = BQ * D * 4;     // bytes of one q half
  static constexpr int KV = BKT * D * 4;   // bytes of k, v, k lo, v^T halves
  static constexpr int QLO = Q;
  static constexpr int RING = 2 * Q;
  static constexpr int KLO = RING + STAGES * 2 * KV;
  static constexpr int VTHI = KLO + KV;
  static constexpr int VTLO = VTHI + KV;
  static constexpr int BARS = VTLO + KV;
  static constexpr size_t bytes = BARS + (2 * STAGES + 1) * 8 + 1024;
  // blocks an SM by shared memory (228 KB, 1 KB of it per block reserved)
  static constexpr int BLOCKS = 233472 / (bytes + 1024);
};

// One block (one warpgroup) per (bh, query tile), as the bf16 kernel: the
// thread owns query rows r0 = warp*16 + lane/4 and r0 + 8, their running
// max m (log2 units, scale applied), its share of the row sum l and its
// columns of o, all fp32.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, Tf32Fwd<D>::BLOCKS)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      float* __restrict__ o, float* __restrict__ lse,
                      int bh_count, int lq, int lk, int causal, int window,
                      float scale) {
  using S = Tf32Fwd<D>;
  using L = Tile<D>;  // o's chunks of W columns
  constexpr int BKT = S::BKT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // the same bytes for the threads' own loads and stores
  float* const fbase = reinterpret_cast<float*>(smem_raw + (base - raw));
  auto at = [&](int off) { return fbase + off / 4; };
  const uint32_t bars = base + S::BARS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t resident = bars + 8 * 2 * STAGES;
  auto ring_k = [&](int s) { return S::RING + s * 2 * S::KV; };

  const int nq = (lq + BQ - 1) / BQ;
  // the longest causal rows are scheduled first
  const int iq = nq - 1 - blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = iq * BQ;
  // key tiles [kt0, kt1) hold every kept pair of this query tile
  const int nk = (lk + BKT - 1) / BKT;
  int kt0 = 0, kt1 = nk;
  if (causal) {
    kt1 = min(nk, (min(q0 + BQ, lq) - 1) / BKT + 1);
    if (window > 0) kt0 = max(0, q0 - window + 1) / BKT;
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
    mbar_expect_tx(full(s), 2 * S::KV);
    tma_f32<D, BKT>(base + ring_k(s), mk, (kt0 + i) * BKT, bh, full(s));
    tma_f32<D, BKT>(base + ring_k(s) + S::KV, mv, (kt0 + i) * BKT, bh,
                    full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, S::Q);
    tma_f32<D, BQ>(base, mq, q0, bh, resident);
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

  if (n > 0) {
    mbar_wait(resident, 0);
    split_tile(at(0), at(S::QLO), S::Q / 16);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt0 + i) * BKT;
    // every warp is past the last tile's products, which read k lo and
    // v^T; then split this tile's k and v
    __syncthreads();
    mbar_wait(full(s), (i / STAGES) & 1);
    split_tile(at(ring_k(s)), at(S::KLO), S::KV / 16);
    transpose_split<D, BKT, false>(at(ring_k(s) + S::KV), nullptr,
                                   at(S::VTHI), at(S::VTLO));
    fence_async_smem();
    __syncthreads();

    float sc[BKT / 2];
    wg_fence();
    score_tf32<D, BKT>(sc, base, base + S::QLO, base + ring_k(s),
                       base + S::KLO);  // s = q k^T
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    // the stage's k and v are consumed: free it for tile i + STAGES
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_wait(empty(s), (i / STAGES) & 1);
      load(i + STAGES);
    }
    __syncwarp();

    // scale (log2 units) and mask; the tile's row max
    const bool edge = !interior<BKT>(q0, k0, lq, lk, causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BKT / 2; ++e) {
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
    // P, and its A fragments hi and lo (split_a: with v^T's positions
    // permuted, the accumulator's registers are A's words as they stand)
#pragma unroll
    for (int e = 0; e < BKT / 2; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = exp2f(sc[e] - mu[h]);
      l[h] += sc[e];
    }
    uint32_t ahi[BKT / 2], alo[BKT / 2];
    split_a(sc, ahi, alo);
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < L::W / 2; ++j) acc[c][j] *= alpha[(j >> 1) & 1];
    wg_fence();
    accumulate_tf32<D, BKT>(acc, ahi, alo, base + S::VTHI,
                            base + S::VTLO);  // o += p v
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) reg_fence(acc[c]);
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
  float* const out = o + ((size_t)bh * lq + q0) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= lq - q0) continue;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < L::W / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * D + c * L::W + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[c][4 * j + 2 * h] * inv[h],
                        acc[c][4 * j + 2 * h + 1] * inv[h]);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int lq, int lk, int causal, int window,
                float scale, cudaStream_t stream) {
  using S = Tf32Fwd<D>;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = f32_map(&mq, q, bh, lq, D, BQ)) ||
      (rc = f32_map(&mk, k, bh, lk, D, S::BKT)) ||
      (rc = f32_map(&mv, v, bh, lk, D, S::BKT)))
    return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((lq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_tf32_kernel<D><<<(unsigned)blocks, TC_THREADS, S::bytes,
                             stream>>>(mq, mk, mv, static_cast<float*>(o),
                                       lse, bh, lq, lk, causal, window,
                                       scale);
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
    case 32: return launch_tf32<32>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 64: return launch_tf32<64>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
    case 128: return launch_tf32<128>(q, k, v, o, lse, bh, lq, lk, causal, window, scale, s);
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
// describe an operand to TMA.
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
