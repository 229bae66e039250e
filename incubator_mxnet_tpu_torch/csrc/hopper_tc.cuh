// Shared pieces of the port's Hopper (sm_90a) tensor-core kernels:
// flash_fwd_tc_kernel and flash_fwd_tf32_kernel (csrc/flash_fwd.cu),
// flash_dq_tc_kernel, flash_dkv_tc_kernel, flash_dq_tf32_kernel and
// flash_dkv_tf32_kernel (csrc/flash_bwd.cu).
//
// A block is one warpgroup (128 threads) that issues every product as
// wgmma m64nNk16 (bf16 operands, fp32 accumulators in registers), or as
// m64nNk8 on tf32 operands for fp32 (the tf32 section below); its
// thread 0 also issues the TMA loads.  Operand tiles are 64 rows of D
// bf16 values in shared memory, in the 128-byte swizzle that TMA writes
// and wgmma's descriptors read (64-byte at D=32; D=128 is two 64-column
// chunks).  Streamed tiles go through a ring of STAGES buffers guarded by
// mbarriers; a barrier phase that has not completed after 4 s traps, so
// a lost load is a launch error, not a hung card.  Tensor maps are 3-D
// (D, L, BH) with 64-row boxes, so rows past L inside a head are
// zero-filled; they are encoded on the host at each call through the
// runtime's driver entry point (no -lcuda) and passed as
// __grid_constant__ parameters.
//
// The fp32 accumulator of m64n64k16 already has the register layout of
// wgmma's A operand: thread (warp, lane) holds rows warp*16 + lane/4 and
// +8, columns 8*j + 2*(lane%4) (+1) in d[4*j + 2*h (+1)] for row half h,
// and the pair (d[2r], d[2r+1]) rounded to packed bf16 is register r of
// the A fragment (4 registers per 16-column step).  So a score tile goes
// from one product to the next without touching shared memory.
//
// Each .cu that includes this header builds into its own library; the
// build hashes every csrc/*.cuh with the source (ops/_build.py), so an
// edited header rebuilds its users.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // keys per tile
constexpr int STAGES = 2;            // ring of streamed tiles
constexpr int WARPS = 4;             // one warpgroup
constexpr int TC_THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of one (64 x D) bf16 tile: CHUNKS chunks of 64
// rows x W columns, each row W * 2 bytes (one swizzle span), as the TMA
// box {W, 64, 1} writes it.
template <int D>
struct Tile {
  static constexpr int W = D < 64 ? D : 64;
  static constexpr int ROW = W * 2;               // bytes
  static constexpr int CHUNKS = D / W;
  static constexpr int CHUNK = 64 * ROW;          // bytes
  static constexpr int BYTES = CHUNKS * CHUNK;
  static constexpr uint64_t SWIZZLE = D < 64 ? 2 : 1;  // 64B : 128B
  static constexpr int GROUP = 8 * ROW;           // an 8-row swizzle atom
};

// Does the mask keep the pair (query qp, key kp)?  Padded rows past Lq or
// Lk never are.
__device__ __forceinline__ bool kept(int qp, int kp, int lq, int lk,
                                     int causal, int window) {
  bool keep = qp < lq && kp < lk;
  if (causal) {
    keep = keep && qp >= kp;
    if (window > 0) keep = keep && qp - kp < window;
  }
  return keep;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Until the barrier's phase of this parity has completed.  A phase that
// has not completed after 4 s (far past any load or tile of work) traps,
// so a fault shows as a launch error, not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One (64 x D) tile, rows [row, row + 64) of head bh, into shared memory
// at dst by TMA; completes `bytes` on the barrier.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map,
                                         int row, int bh, uint32_t bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(&map);
#pragma unroll
  for (int c = 0; c < Tile<D>::CHUNKS; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            dst + c * Tile<D>::CHUNK),
        "l"(m), "r"(bar), "r"(c * Tile<D>::W), "r"(row), "r"(bh)
        : "memory");
}

// 64 consecutive floats of a 1-D map from element `at` (zeros past its end).
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap& map,
                                        int at, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(at)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile at `addr`.  Both byte
// offsets are the 8-row atom: the K-major operands (K = 16 columns
// within one swizzle row) read only the stride between atoms, and the
// MN-major ones (N = W columns, one atom wide) step K over two atoms.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t off = Tile<D>::GROUP >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (off << 16) |
         (off << 32) | (Tile<D>::SWIZZLE << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers
// across the asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MXT_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), both from shared memory,
// K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXT_D8(0), MXT_D8(8), MXT_D8(16), MXT_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x W) += A (64 x 16, bf16 pairs in registers) . B (16 x W) from
// shared memory, MN-major (transposed).
template <int W>
__device__ __forceinline__ void mma_rs(float (&d)[W / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8), MXT_D8(16), MXT_D8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// ------------------------------------------------ tf32 (fp32 operands)
// A .tf32 operand is a 32-bit register or shared-memory word.  PTX leaves
// the tf32 layout to the implementation and converts with cvt.rna.tf32,
// which clears the low 13 bits; the split-fp32 kernels therefore store
// every operand with those bits already clear (tf32_hi), so the product
// does not depend on whether the tensor core truncates or rounds them.
// PTX has no transpose flag for .tf32: both shared-memory operands are
// K-major.

// d (64 x N) (+)= A (64 x 8) . B (8 x N), tf32 operands from shared
// memory, both K-major; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma_ss_tf32(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void mma_ss_tf32<64>(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8), MXT_D8(16), MXT_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void mma_ss_tf32<32>(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void mma_ss_tf32<16>(float (&d)[8], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : MXT_D8(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (64 x 8, tf32 words in registers) . B (8 x N) from
// shared memory, K-major.  Thread (warp, lane) holds A's rows warp*16 +
// lane/4 (a0: column lane%4, a2: column lane%4 + 4) and the same + 8
// (a1, a3).
template <int N>
__device__ __forceinline__ void mma_rs_tf32(float (&d)[N / 2], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db);
template <>
__device__ __forceinline__ void mma_rs_tf32<64>(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8), MXT_D8(16), MXT_D8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_tf32<32>(float (&d)[16], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : MXT_D8(0), MXT_D8(8)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
#undef MXT_D8

// The high part of x as tf32 sees it: x with its low 13 bits cleared.
// x - tf32_hi(x) is exact in fp32 and holds the 13 bits that a single
// tf32 product would drop.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// fp32 tiles: rows of D floats stored as D/32 chunks of 32 columns, each
// row of a chunk one 128-byte swizzle span, as the TMA box {32, rows, 1}
// writes it.  A k8 tf32 step is 32 bytes, as bf16's k16 is, so the
// descriptor arithmetic is Tile<64>'s: 8-row atoms of 1024 bytes (the
// stride between atoms), 128-byte swizzle, and a k step adds 32 bytes to
// the start address inside the atom's rows.
__device__ __forceinline__ uint64_t desc_f32(uint32_t addr) {
  return desc<64>(addr);
}

// Float index of (row r, column c) in an fp32 tile of `rows` rows: chunk
// c / 32, then the 16-byte unit (c % 32) / 4 XOR the row's place in its
// 8-row atom (the 128-byte swizzle; the tile is 1024-byte aligned).
__device__ __forceinline__ int f32_at(int r, int c, int rows) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

// Float index of (row r, column c) in a transposed fp32 tile of `rows`
// rows whose columns run in chunks of COLS: 32 (each row of a chunk one
// 128-byte swizzle span, as f32_at) or 16 (one 64-byte span: the 16-byte
// unit XOR bits 1-2 of the row, the 64-byte swizzle; the tile is
// 512-byte aligned).
template <int COLS>
__device__ __forceinline__ int tr_at(int r, int c, int rows) {
  static_assert(COLS == 16 || COLS == 32, "a 64- or 128-byte span");
  const int sw = COLS == 32 ? (r & 7) : ((r >> 1) & 3);
  return (c / COLS) * rows * COLS + r * COLS +
         ((((c >> 2) % (COLS / 4)) ^ sw) << 2) + (c & 3);
}

// Columns per chunk of the transposed tile of a ROWS-row streamed tile.
template <int ROWS>
struct TrTile {
  static constexpr int COLS = ROWS < 32 ? ROWS : 32;
  static constexpr int ROW = COLS * 4;  // bytes
};

// wgmma descriptor of a transposed tile (TrTile<ROWS>) at `addr`: the
// byte arithmetic of bf16's Tile<64> (128-byte rows) or Tile<32> (64-byte
// rows, 64-byte swizzle); a k8 tf32 step is 32 bytes, as bf16's k16.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_tr(uint32_t addr) {
  return desc<TrTile<ROWS>::COLS * 2>(addr);
}

// hi in place and lo = x - hi beside it, for `count` float4s of a tile
// (both halves in the same swizzled layout, so no index arithmetic).
__device__ __forceinline__ void split_tile(float* hi, float* lo, int count) {
  for (int i = threadIdx.x; i < count; i += TC_THREADS) {
    const float4 x = reinterpret_cast<const float4*>(hi)[i];
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                 tf32_hi(x.w));
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] =
        make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
}

// x (ROWS rows x D, as TMA landed it) to x^T (D rows x ROWS positions,
// K-major for a product that sums over x's rows) in hi and lo halves
// (TrTile<ROWS> layout); with IN_PLACE, x's hi also goes back over x and
// its lo to xlo (x's layout), as split_tile writes them.  Positions are
// rows permuted inside each group of 8: position 8j + t + 4e holds row
// 8j + 2t + e (t < 4, e < 2), the order in which a score accumulator
// holds its columns, so that accumulator's registers are wgmma's A
// fragment as they stand (see accumulate_tf32).  Every element is read
// and written by one thread.  A warp takes 32 consecutive rows d of x^T
// for one group of 4 positions: its loads read one 128-byte row of x,
// its 16-byte stores land in distinct bank groups per phase (the
// swizzle).
template <int D, int ROWS, bool IN_PLACE>
__device__ __forceinline__ void transpose_split(float* x, float* xlo,
                                                float* thi, float* tlo) {
  for (int i = threadIdx.x; i < D * ROWS / 4; i += TC_THREADS) {
    const int d = i % D;
    const int pos = 4 * (i / D);
    const int row = (pos & ~7) + ((pos >> 2) & 1);  // rows row + 2t
    float v[4], h[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int at = f32_at(row + 2 * t, d, ROWS);
      v[t] = x[at];
      h[t] = tf32_hi(v[t]);
      if (IN_PLACE) {
        x[at] = h[t];
        xlo[at] = v[t] - h[t];
      }
    }
    const int at = tr_at<TrTile<ROWS>::COLS>(d, pos, D);
    *reinterpret_cast<float4*>(thi + at) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(tlo + at) =
        make_float4(v[0] - h[0], v[1] - h[1], v[2] - h[2], v[3] - h[3]);
  }
}

// s = A . B^T over D in three tf32 products, lo.hi and hi.lo first (the
// small terms), then hi.hi: A a 64-row fp32 tile (hi and lo halves), B a
// BN-row one, both as TMA lands them (D / 32 chunks of 128-byte rows).
template <int D, int BN>
__device__ __forceinline__ void score_tf32(float (&s)[BN / 2], uint32_t ahi,
                                           uint32_t alo, uint32_t bhi,
                                           uint32_t blo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t oa = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const uint32_t ob = (kk / 4) * BN * 128 + (kk % 4) * 32;
    mma_ss_tf32<BN>(s, desc_f32(alo + oa), desc_f32(bhi + ob), kk > 0);
    mma_ss_tf32<BN>(s, desc_f32(ahi + oa), desc_f32(blo + ob), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss_tf32<BN>(s, desc_f32(ahi + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                    desc_f32(bhi + (kk / 4) * BN * 128 + (kk % 4) * 32), 1);
}

// The A fragment word of score accumulator register e (see
// transpose_split's permutation): the accumulator holds columns 8kk + 2t
// (+1) of rows r0 (+8) in s[4kk + 2h (+1)]; with the B operand's rows
// permuted, A's column t is 8kk + 2t and column t + 4 is 8kk + 2t + 1, so
// a0..a3 = (r0, 2t), (r0 + 8, 2t), (r0, 2t + 1), (r0 + 8, 2t + 1):
// e = 4kk + 2h + c goes to word 4kk + h + 2c.
__device__ __forceinline__ int a_word(int e) {
  return (e & ~3) + ((e >> 1) & 1) + 2 * (e & 1);
}

// x split into hi and lo tf32 words, at A fragment word a_word(e).
template <int N>
__device__ __forceinline__ void split_a(const float (&x)[N],
                                        uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float h = tf32_hi(x[e]);
    hi[a_word(e)] = __float_as_uint(h);
    lo[a_word(e)] = __float_as_uint(x[e] - h);
  }
}

// acc (64 x D) += A . B in three tf32 products: A (64 x BN) as register
// fragments, hi and lo (4 words per 8-column step); B^T's hi and lo (D
// rows of BN positions, TrTile<BN> layout, as transpose_split writes
// them); acc in Tile<D>::CHUNKS products of Tile<D>::W columns.
template <int D, int BN>
__device__ __forceinline__ void accumulate_tf32(
    float (&acc)[Tile<D>::CHUNKS][Tile<D>::W / 2],
    const uint32_t (&ahi)[BN / 2], const uint32_t (&alo)[BN / 2],
    uint32_t thi, uint32_t tlo) {
  constexpr int W = Tile<D>::W;
  constexpr int COLS = TrTile<BN>::COLS, ROW = TrTile<BN>::ROW;
#pragma unroll
  for (int c = 0; c < Tile<D>::CHUNKS; ++c) {
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t off = (kk * 8 / COLS) * D * ROW + c * W * ROW +
                           (kk * 8 % COLS) * 4;
      mma_rs_tf32<W>(acc[c], alo[4 * kk], alo[4 * kk + 1], alo[4 * kk + 2],
                     alo[4 * kk + 3], desc_tr<BN>(thi + off));
      mma_rs_tf32<W>(acc[c], ahi[4 * kk], ahi[4 * kk + 1], ahi[4 * kk + 2],
                     ahi[4 * kk + 3], desc_tr<BN>(tlo + off));
    }
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t off = (kk * 8 / COLS) * D * ROW + c * W * ROW +
                           (kk * 8 % COLS) * 4;
      mma_rs_tf32<W>(acc[c], ahi[4 * kk], ahi[4 * kk + 1], ahi[4 * kk + 2],
                     ahi[4 * kk + 3], desc_tr<BN>(thi + off));
    }
  }
}

// Generic-proxy writes to shared memory (st.shared) become visible to the
// async proxy (wgmma's operand reads, TMA) after this fence and a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One (ROWS x D) fp32 tile, rows [row, row + ROWS) of head bh, into
// shared memory at dst by TMA (D / 32 boxes); completes its bytes on the
// barrier.
template <int D, int ROWS>
__device__ __forceinline__ void tma_f32(uint32_t dst, const CUtensorMap& map,
                                        int row, int bh, uint32_t bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(&map);
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            dst + c * ROWS * 128),
        "l"(m), "r"(bar), "r"(c * 32), "r"(row), "r"(bh)
        : "memory");
}

// s = A . B^T over D, for two (64 x D) tiles in shared memory.
template <int D>
__device__ __forceinline__ void score_tc(float (&s)[32], uint32_t a,
                                         uint32_t b) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / L::W) * L::CHUNK + (kk * 16 % L::W) * 2;
    mma_ss_n64(s, desc<D>(a + off), desc<D>(b + off), kk > 0);
  }
}

// acc += A . B: A the (64 x 64) bf16 fragments a[16] (4 per 16-column
// step), B a (64 x D) tile in shared memory.
template <int D>
__device__ __forceinline__ void accumulate_tc(
    float (&acc)[Tile<D>::CHUNKS][Tile<D>::W / 2], const uint32_t (&a)[16],
    uint32_t b) {
  using L = Tile<D>;
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<L::W>(acc[c], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                   a[4 * kk + 3],
                   desc<D>(b + c * L::CHUNK + kk * 16 * L::ROW));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Does every pair of the (query tile q0 of BQN queries, key tile k0 of
// BKN keys) block survive the mask?  Then the block skips it.
template <int BKN = BK, int BQN = BQ>
__device__ __forceinline__ bool interior(int q0, int k0, int lq, int lk,
                                         int causal, int window) {
  bool all = q0 + BQN <= lq && k0 + BKN <= lk;
  if (causal) {
    all = all && k0 + BKN - 1 <= q0;
    if (window > 0) all = all && q0 + BQN - 1 - k0 < window;
  }
  return all;
}

// The (64 x W) accumulator chunks of this thread's rows r0 and r0 + 8 to
// bf16 rows of `out` (row stride D), rows at or past `valid` skipped.
template <int D>
__device__ __forceinline__ void store_rows(
    const float (&acc)[Tile<D>::CHUNKS][Tile<D>::W / 2],
    __nv_bfloat16* out, int r0, int valid, int lane) {
  using L = Tile<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < L::W / 8; ++j) {
        const int col = c * 64 + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * D + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * h],
                                  acc[c][4 * j + 2 * h + 1]);
      }
  }
}

// ------------------------------------------------ host: tensor maps

// cuTensorMapEncodeTiled is a driver-API call: fetched through the
// runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (bh, rows, D) bf16 tensor at `base` as 3-D TMA boxes of 64 rows x
// Tile<D>::W columns, swizzled as wgmma reads them; rows past `rows` are
// zero-filled.
template <int D>
int tile_map(CUtensorMap* map, const void* base, int bh, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -5;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Tile<D>::W, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

// The (bh, rows, d) fp32 tensor at `base` as 3-D TMA boxes of box_rows
// rows x 32 columns (one 128-byte swizzle span), swizzled as wgmma reads
// them; rows past `rows` are zero-filled.
int f32_map(CUtensorMap* map, const void* base, int bh, int rows, int d,
            int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -5;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)rows * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

// n fp32 values at `base` as a 1-D map of `box`-value boxes.
int row_map(CUtensorMap* map, const float* base, long long n, int box = BQ) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -5;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unused at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
      dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

}  // namespace
