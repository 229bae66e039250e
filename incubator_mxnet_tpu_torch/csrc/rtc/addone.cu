// o = x + 1 over 8-row tiles: the port's twin of the Pallas kernel
// `addone_kernel` (tests/test_rtc.py:93), whose grid is rows / 8 blocks
// of (8, C) rows; built and launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.
//
// Design: 16-byte accesses, one float4 a thread.  blockIdx.y is the
// 8-row tile (the Pallas grid axis); a tile of a row-major array is one
// contiguous span of 8 * cols elements, which the blockIdx.x blocks of
// that tile walk in a grid-stride loop of float4s (a warp reads 512
// contiguous bytes per load) with the streaming, evict-first hints
// (__ldcs, __stcs).  The wrapper's grid (rtc_examples._tiles) gives each
// tile enough blocks to cover it in one pass.  On an H100 this body
// reads level with torch.add(x, 1) within the spread of interleaved
// traces; scale.cu's design (several float4s in flight a thread) read
// no better and was not kept (PERF.md's B5b row;
// tools/addone_variants.py times the variants).
//
// The last tile may be ragged (rows past `rows` are not there; the
// Pallas grid rows // 8 never writes them, and the tests hold parity
// only at shapes JAX accepts).  A tile not 16-byte aligned (cols not a
// multiple of 4, or x or o misaligned) goes through the scalar loop, as
// does the tail of a tile.  x + 1 rounds once on either path, so the
// kernel equals its plain version bit for bit.
__global__ void addone(const float* __restrict__ x, float* __restrict__ o,
                       long long rows, long long cols) {
  const long long r0 = (long long)blockIdx.y * 8;
  const long long r1 = r0 + 8 < rows ? r0 + 8 : rows;
  const long long n = (r1 - r0) * cols;          // the tile's elements
  const float* __restrict__ xt = x + r0 * cols;
  float* __restrict__ ot = o + r0 * cols;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;     // elements the float4 loop covered
  if (((reinterpret_cast<unsigned long long>(xt) |
        reinterpret_cast<unsigned long long>(ot)) & 15) == 0) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xt);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(ot);
    const long long n4 = n >> 2;
    for (long long i = first; i < n4; i += stride) {
      float4 v = __ldcs(x4 + i);
      v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
      __stcs(o4 + i, v);
    }
    done = n4 << 2;
  }
  for (long long i = done + first; i < n; i += stride)
    ot[i] = xt[i] + 1.0f;
}
