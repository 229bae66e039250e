// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: two
// kernels, flash_dq and flash_dkv, each in two builds, both on the tensor
// cores (wgmma fed by TMA): bf16 as it is, fp32 as split-TF32 (three tf32
// products per fp32 product).
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
// traffic.  In fp32 each product is three tf32 products: 0.156 and 0.208
// ms at 495 TFLOP/s, against ~0.1 ms of traffic.
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
// fp32 (flash_dq_tf32_kernel, flash_dkv_tf32_kernel): the bf16 kernels'
// block, ownership, band walk and masks, with every product split as
// flash_fwd_tf32_kernel (csrc/flash_fwd.cu) splits its own.  One tf32
// product keeps 11 of fp32's 24 mantissa bits and cannot meet the fp32
// check (1e-4, abs + rel); split-TF32 can: x = hi + lo, hi = x with its
// low 13 bits cleared (tf32_hi), lo = x - hi (exact), and a . b =
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, summed in fp32 by wgmma
// m64nNk8 .tf32.  Where the design meets trouble:
// - tf32 operands in shared memory must be K-major (PTX has no transpose
//   flag for .tf32).  The score products (s = q k^T, dp = g v^T in
//   flash_dq; s^T = k q^T, dp^T = v g^T in flash_dkv) are K-major as TMA
//   lands both operands (rows along D): each landed tile is split in
//   place (hi) with its lo beside it.  The gradient products (dq += ds k;
//   dv += p^T g, dk += ds^T q) sum over the streamed tile's rows, so
//   their B operand is that tile transposed: the pass that splits a
//   landed k (flash_dq) or q and g (flash_dkv) also writes its transpose,
//   hi and lo, in the same pass (transpose_split in csrc/hopper_tc.cuh),
//   every element read and written by one thread.
// - The gradient products take A (ds, or p^T and ds^T) straight from the
//   score accumulators, split into hi and lo in registers.  The tf32 A
//   fragment of m64k8 holds columns t and t + 4 (t = lane % 4), the fp32
//   accumulator columns 2t and 2t + 1, so the transposed tile's positions
//   are its rows permuted inside each group of 8 (row 8j + 2t at position
//   8j + t, row 8j + 2t + 1 at 8j + t + 4), as the forward permutes v^T.
// - Shared memory sets occupancy.  Per block: the resident 64-row tiles'
//   hi and lo (q, g or k, v: 4 x 64 x D floats), a 2-stage ring of the
//   streamed pairs, their lo halves, and the transposed copies (k^T for
//   flash_dq; q^T and g^T for flash_dkv), hi and lo.  BN streamed rows a
//   tile (keys for dq, queries for dkv; the score products' N):
//     D=32,  BN=32: dq  64 KB, 3 blocks an SM; dkv  72 KB, 3
//     D=64,  BN=16: dq  96 KB, 2 blocks an SM; dkv 104 KB, 2
//                   (BN=32: 128 and 144 KB, 1 block)
//     D=128, BN=16: dq 192 KB, 1 block an SM;  dkv 208 KB, 1
//   The transposed tiles of 16 positions are 64-byte rows in the 64-byte
//   swizzle (tr_at, desc_tr); of 32, 128-byte rows in the 128-byte one.
// - Barriers.  Each tile: a barrier (every warp is past the last tile's
//   gradient products, which read the lo halves and the transposes),
//   the splits, fence.proxy.async (wgmma reads shared memory through the
//   async proxy) and a barrier; the score products; the ring stage is
//   freed once both are done (flash_dkv first reads its lse and delta
//   slices into registers), so the next load overlaps the softmax and
//   the gradient products.  In flash_dkv, ds^T is computed while dv's
//   product runs.
// - lse and delta: per row into registers (flash_dq), per column by TMA
//   with each streamed tile (flash_dkv).  p = exp(s * scale - lse) with
//   expf, as the plain version computes it; every sum stays fp32.
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
// - Shared memory: up to 208 KB a block (the fp32 flash_dkv at D=128),
//   past the 48 KB static limit, so every kernel takes dynamic shared
//   memory after cudaFuncSetAttribute.
//
// Layout: q, g and dq (BH, Lq, D); k, v, dk and dv (BH, Lk, D); lse and
// delta (BH, Lq) fp32; all contiguous and 16-byte aligned (TMA).
// The kernels allocate nothing and run on the caller's stream; the C
// entry points return a cudaError_t (or a negative code for arguments
// they do not take).

#include "hopper_tc.cuh"

namespace {

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

// ------------------------------------------------ fp32: split-TF32 wgmma

// Streamed rows per tile of the fp32 kernels (keys for flash_dq, queries
// for flash_dkv) and their shared memory, byte offsets from a 1024-
// aligned base.  flash_dq: q and g (resident), each as its hi (TMA-
// landed, split in place) and lo; a ring of STAGES (k, v) pairs as TMA
// lands them, each split in place; k's and v's lo; k^T's hi and lo; the
// barriers (full[STAGES], empty[STAGES], resident).
template <int D>
struct Tf32Dq {
  static constexpr int BN = D == 32 ? 32 : 16;
  static constexpr int R = BQ * D * 4;   // bytes of one resident half
  static constexpr int T = BN * D * 4;   // a streamed tile, a lo, a ^T half
  static constexpr int QLO = R, GHI = 2 * R, GLO = 3 * R;
  static constexpr int RING = 4 * R;
  static constexpr int KLO = RING + STAGES * 2 * T;
  static constexpr int VLO = KLO + T;
  static constexpr int KTHI = VLO + T;
  static constexpr int KTLO = KTHI + T;
  static constexpr int BARS = KTLO + T;
  static constexpr size_t bytes = BARS + (2 * STAGES + 1) * 8 + 1024;
  // blocks an SM by shared memory (228 KB, 1 KB of it per block reserved)
  static constexpr int BLOCKS = 233472 / (bytes + 1024);
};

// flash_dkv: k and v (resident), hi and lo; a ring of STAGES (q, g)
// pairs, each split in place; q's and g's lo; q^T's and g^T's hi and lo;
// each stage's lse and delta slices (64 floats apart); the barriers.
template <int D>
struct Tf32Dkv {
  static constexpr int BN = D == 32 ? 32 : 16;
  static constexpr int R = BQ * D * 4;
  static constexpr int T = BN * D * 4;
  static constexpr int KLO = R, VHI = 2 * R, VLO = 3 * R;
  static constexpr int RING = 4 * R;
  static constexpr int QLO = RING + STAGES * 2 * T;
  static constexpr int GLO = QLO + T;
  static constexpr int QTHI = GLO + T;
  static constexpr int QTLO = QTHI + T;
  static constexpr int GTHI = QTLO + T;
  static constexpr int GTLO = GTHI + T;
  static constexpr int ROWS = GTLO + T;
  static constexpr int BARS = ROWS + STAGES * 2 * 256;
  static constexpr size_t bytes = BARS + (2 * STAGES + 1) * 8 + 1024;
  static constexpr int BLOCKS = 233472 / (bytes + 1024);
};

// The (64 x W) fp32 accumulator chunks of this thread's rows r0 and r0 +
// 8 to rows of `out` (row stride D), rows at or past `valid` skipped.
template <int D>
__device__ __forceinline__ void store_rows_f32(
    const float (&acc)[Tile<D>::CHUNKS][Tile<D>::W / 2], float* out, int r0,
    int valid, int lane) {
  using L = Tile<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < L::W / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * D + c * L::W + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[c][4 * j + 2 * h], acc[c][4 * j + 2 * h + 1]);
  }
}

// One block (one warpgroup) per (bh, query tile), as flash_dq_tc_kernel;
// the thread owns query rows r0 = warp*16 + lane/4 and r0 + 8.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, Tf32Dq<D>::BLOCKS)
flash_dq_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mg,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int bh_count, int lq, int lk, int causal, int window,
                     float scale) {
  using S = Tf32Dq<D>;
  constexpr int BN = S::BN;
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
  auto ring_k = [&](int s) { return S::RING + s * 2 * S::T; };

  const int nq = (lq + BQ - 1) / BQ;
  // the longest causal rows are scheduled first
  const int iq = nq - 1 - blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = iq * BQ;
  // key tiles [kt0, kt1) hold every kept pair of this query tile
  const int nk = (lk + BN - 1) / BN;
  int kt0 = 0, kt1 = nk;
  if (causal) {
    kt1 = min(nk, (min(q0 + BQ, lq) - 1) / BN + 1);
    if (window > 0) kt0 = max(0, q0 - window + 1) / BN;
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

  // thread 0 issues every load: q and g once, and each (k, v) pair into
  // its ring stage once the stage is free
  auto load = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(full(s), 2 * S::T);
    tma_f32<D, BN>(base + ring_k(s), mk, (kt0 + i) * BN, bh, full(s));
    tma_f32<D, BN>(base + ring_k(s) + S::T, mv, (kt0 + i) * BN, bh, full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, 2 * S::R);
    tma_f32<D, BQ>(base, mq, q0, bh, resident);
    tma_f32<D, BQ>(base + S::GHI, mg, q0, bh, resident);
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  float lse_r[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    const bool in = qp < lq;  // padded rows: never read past Lq
    lse_r[h] = in ? lse[(size_t)bh * lq + qp] : 0.f;
    dl[h] = in ? delta[(size_t)bh * lq + qp] : 0.f;
  }
  float acc[Tile<D>::CHUNKS][Tile<D>::W / 2];
#pragma unroll
  for (int c = 0; c < Tile<D>::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < Tile<D>::W / 2; ++i) acc[c][i] = 0.f;

  if (n > 0) {
    mbar_wait(resident, 0);
    split_tile(at(0), at(S::QLO), S::R / 16);
    split_tile(at(S::GHI), at(S::GLO), S::R / 16);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt0 + i) * BN;
    // every warp is past the last tile's products, which read k lo, v lo
    // and k^T; then split this tile's k (and transpose it) and v
    __syncthreads();
    mbar_wait(full(s), (i / STAGES) & 1);
    transpose_split<D, BN, true>(at(ring_k(s)), at(S::KLO), at(S::KTHI),
                                 at(S::KTLO));
    split_tile(at(ring_k(s) + S::T), at(S::VLO), S::T / 16);
    fence_async_smem();
    __syncthreads();

    float sc[BN / 2], dp[BN / 2];
    wg_fence();
    score_tf32<D, BN>(sc, base, base + S::QLO, base + ring_k(s),
                      base + S::KLO);  // s = q k^T
    wg_commit();
    score_tf32<D, BN>(dp, base + S::GHI, base + S::GLO,
                      base + ring_k(s) + S::T, base + S::VLO);  // dp = g v^T
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    const bool edge = !interior<BN>(q0, k0, lq, lk, causal, window);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int h = (e >> 1) & 1;
      float p = expf(fmaf(sc[e], scale, -lse_r[h]));
      if (edge) {
        const int qp = q0 + r0 + 8 * h;
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (!kept(qp, kp, lq, lk, causal, window)) p = 0.f;
      }
      sc[e] = p;
    }
    wg_wait<0>();
    reg_fence(dp);
    // the stage's k and v are consumed: free it for tile i + STAGES
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_wait(empty(s), (i / STAGES) & 1);
      load(i + STAGES);
    }
    __syncwarp();

#pragma unroll
    for (int e = 0; e < BN / 2; ++e)
      dp[e] = sc[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;  // ds
    uint32_t ahi[BN / 2], alo[BN / 2];
    split_a(dp, ahi, alo);
    wg_fence();
    accumulate_tf32<D, BN>(acc, ahi, alo, base + S::KTHI,
                           base + S::KTLO);  // dq += ds k
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < Tile<D>::CHUNKS; ++c) reg_fence(acc[c]);
  }
  store_rows_f32<D>(acc, dq + ((size_t)bh * lq + q0) * D, r0, lq - q0, lane);
}

// One block (one warpgroup) per (bh, key tile), as flash_dkv_tc_kernel;
// the thread owns key rows r0 = warp*16 + lane/4 and r0 + 8 of the
// transposed score tiles and of dk and dv.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, Tf32Dkv<D>::BLOCKS)
flash_dkv_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mg,
                      const __grid_constant__ CUtensorMap mlse,
                      const __grid_constant__ CUtensorMap mdelta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int bh_count, int lq, int lk, int causal, int window,
                      float scale) {
  using S = Tf32Dkv<D>;
  constexpr int BN = S::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const fbase = reinterpret_cast<float*>(smem_raw + (base - raw));
  auto at = [&](int off) { return fbase + off / 4; };
  const uint32_t bars = base + S::BARS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t resident = bars + 8 * 2 * STAGES;
  auto ring_q = [&](int s) { return S::RING + s * 2 * S::T; };
  // lse of stage s at ring_rows(s), delta 256 bytes on
  auto ring_rows = [&](int s) { return S::ROWS + s * 2 * 256; };

  // the first key tiles see the most query tiles: scheduled first
  const int jk = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int k0 = jk * BK;
  // query tiles [it0, it1) hold every kept pair of this key tile: from
  // the causal diagonal to the end of the window band
  const int nq = (lq + BN - 1) / BN;
  int it0 = 0, it1 = nq;
  if (causal) {
    it0 = min(nq, k0 / BN);
    if (window > 0)
      it1 = min(nq, (min(k0 + BK, lk) - 1 + window - 1) / BN + 1);
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

  // thread 0 issues every load: k and v once, and each (q, g) pair with
  // its lse and delta into its ring stage once the stage is free
  auto load = [&](int i) {
    const int s = i % STAGES;
    const int q0 = (it0 + i) * BN;
    mbar_expect_tx(full(s), 2 * S::T + 2 * BN * 4);
    tma_f32<D, BN>(base + ring_q(s), mq, q0, bh, full(s));
    tma_f32<D, BN>(base + ring_q(s) + S::T, mg, q0, bh, full(s));
    // rows past Lq read the next head's values (or zeros past the end):
    // their pairs are masked
    tma_row(base + ring_rows(s), mlse, bh * lq + q0, full(s));
    tma_row(base + ring_rows(s) + 256, mdelta, bh * lq + q0, full(s));
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(resident, 2 * S::R);
    tma_f32<D, BQ>(base, mk, k0, bh, resident);
    tma_f32<D, BQ>(base + S::VHI, mv, k0, bh, resident);
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  float acc_k[Tile<D>::CHUNKS][Tile<D>::W / 2];
  float acc_v[Tile<D>::CHUNKS][Tile<D>::W / 2];
#pragma unroll
  for (int c = 0; c < Tile<D>::CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < Tile<D>::W / 2; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  if (n > 0) {
    mbar_wait(resident, 0);
    split_tile(at(0), at(S::KLO), S::R / 16);
    split_tile(at(S::VHI), at(S::VLO), S::R / 16);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int q0 = (it0 + i) * BN;
    // every warp is past the last tile's products, which read q lo, g lo,
    // q^T and g^T; then split and transpose this tile's q and g
    __syncthreads();
    mbar_wait(full(s), (i / STAGES) & 1);
    transpose_split<D, BN, true>(at(ring_q(s)), at(S::QLO), at(S::QTHI),
                                 at(S::QTLO));
    transpose_split<D, BN, true>(at(ring_q(s) + S::T), at(S::GLO),
                                 at(S::GTHI), at(S::GTLO));
    fence_async_smem();
    __syncthreads();

    float st[BN / 2], dpt[BN / 2];
    wg_fence();
    score_tf32<D, BN>(st, base, base + S::KLO, base + ring_q(s),
                      base + S::QLO);  // s^T = k q^T
    wg_commit();
    score_tf32<D, BN>(dpt, base + S::VHI, base + S::VLO,
                      base + ring_q(s) + S::T, base + S::GLO);  // dp^T = v g^T
    wg_commit();
    // lse and delta of this thread's query columns 8j + 2t (+1)
    const float* rows = at(ring_rows(s));
    float2 l2[BN / 8], d2[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      l2[j] = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * (lane & 3));
      d2[j] = *reinterpret_cast<const float2*>(rows + 64 + 8 * j +
                                               2 * (lane & 3));
    }
    wg_wait<1>();
    reg_fence(st);
    const bool edge = !interior<BK, BN>(q0, k0, lq, lk, causal, window);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const float2 l = l2[e >> 2];
      float p = expf(fmaf(st[e], scale, -(e & 1 ? l.y : l.x)));
      if (edge) {
        const int kp = k0 + r0 + 8 * ((e >> 1) & 1);
        const int qp = q0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (!kept(qp, kp, lq, lk, causal, window)) p = 0.f;
      }
      st[e] = p;
    }
    wg_wait<0>();
    reg_fence(dpt);
    // the stage's q, g, lse and delta are consumed: free it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_wait(empty(s), (i / STAGES) & 1);
      load(i + STAGES);
    }
    __syncwarp();

    uint32_t phi[BN / 2], plo[BN / 2];
    split_a(st, phi, plo);
    wg_fence();
    accumulate_tf32<D, BN>(acc_v, phi, plo, base + S::GTHI,
                           base + S::GTLO);  // dv += p^T g
    wg_commit();
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const float2 d = d2[e >> 2];
      dpt[e] = st[e] * (dpt[e] - (e & 1 ? d.y : d.x)) * scale;  // ds^T
    }
    uint32_t shi[BN / 2], slo[BN / 2];
    split_a(dpt, shi, slo);
    wg_fence();
    accumulate_tf32<D, BN>(acc_k, shi, slo, base + S::QTHI,
                           base + S::QTLO);  // dk += ds^T q
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < Tile<D>::CHUNKS; ++c) {
      reg_fence(acc_k[c]);
      reg_fence(acc_v[c]);
    }
  }
  // every row of the tile is written, zeros where no query reached it
  store_rows_f32<D>(acc_k, dk + ((size_t)bh * lk + k0) * D, r0, lk - k0,
                    lane);
  store_rows_f32<D>(acc_v, dv + ((size_t)bh * lk + k0) * D, r0, lk - k0,
                    lane);
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

template <int D>
int launch_dq_tf32(const Args& a) {
  using S = Tf32Dq<D>;
  CUtensorMap mq, mk, mv, mg;
  int rc;
  if ((rc = f32_map(&mq, a.q, a.bh, a.lq, D, BQ)) ||
      (rc = f32_map(&mk, a.k, a.bh, a.lk, D, S::BN)) ||
      (rc = f32_map(&mv, a.v, a.bh, a.lk, D, S::BN)) ||
      (rc = f32_map(&mg, a.g, a.bh, a.lq, D, BQ)))
    return rc;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dq_tf32_kernel<D>, S::bytes,
                            (a.lq + BQ - 1) / BQ, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dq_tf32_kernel<D><<<blocks, TC_THREADS, S::bytes, a.stream>>>(
      mq, mk, mv, mg, a.lse, a.delta, static_cast<float*>(a.dq), a.bh, a.lq,
      a.lk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const Args& a) {
  using S = Tf32Dkv<D>;
  CUtensorMap mq, mk, mv, mg, mlse, mdelta;
  const long long rows = (long long)a.bh * a.lq;
  if (rows > 0x7fffffffLL) return -3;  // TMA coordinates are 32-bit
  int rc;
  if ((rc = f32_map(&mq, a.q, a.bh, a.lq, D, S::BN)) ||
      (rc = f32_map(&mk, a.k, a.bh, a.lk, D, BK)) ||
      (rc = f32_map(&mv, a.v, a.bh, a.lk, D, BK)) ||
      (rc = f32_map(&mg, a.g, a.bh, a.lq, D, S::BN)) ||
      (rc = row_map(&mlse, a.lse, rows, S::BN)) ||
      (rc = row_map(&mdelta, a.delta, rows, S::BN)))
    return rc;
  unsigned blocks = 0;
  cudaError_t err = prepare(flash_dkv_tf32_kernel<D>, S::bytes,
                            (a.lk + BK - 1) / BK, a.bh, &blocks);
  if (err != cudaSuccess) return err;
  flash_dkv_tf32_kernel<D><<<blocks, TC_THREADS, S::bytes, a.stream>>>(
      mq, mk, mv, mg, mlse, mdelta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.bh, a.lq, a.lk, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

// which = 0: flash_dq, 1: flash_dkv
int dispatch_f32(int which, int d, const Args& a) {
  switch (d) {
    case 32: return which ? launch_dkv_tf32<32>(a) : launch_dq_tf32<32>(a);
    case 64: return which ? launch_dkv_tf32<64>(a) : launch_dq_tf32<64>(a);
    case 128: return which ? launch_dkv_tf32<128>(a) : launch_dq_tf32<128>(a);
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
// describe an operand to TMA.
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
