// o = x + 1 over 8-row tiles: the port's twin of the Pallas kernel
// `addone_kernel` (tests/test_rtc.py:93), whose grid is rows / 8 blocks
// of (8, C) rows; built and launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.
//
// Design: a 2-D grid.  blockIdx.y is the 8-row tile (the Pallas grid
// axis); blockIdx.x cuts the columns into blockDim.x-wide strips, since
// one block of threads cannot span a 4096-wide row.  Each thread walks
// the 8 rows of its tile at one column: a warp reads 128 contiguous
// bytes per row.  The ragged edges are masked: columns past `cols`, and
// rows past `rows` in the last tile (the Pallas grid rows // 8 never
// writes those rows; the tests hold parity only at shapes JAX accepts).
// x + 1 rounds once, so the kernel equals its plain version bit for bit.
__global__ void addone(const float* __restrict__ x, float* __restrict__ o,
                       long long rows, long long cols) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long r0 = (long long)blockIdx.y * 8;
  const long long r1 = r0 + 8 < rows ? r0 + 8 : rows;
  for (long long r = r0; r < r1; ++r)
    o[r * cols + c] = x[r * cols + c] + 1.0f;
}
