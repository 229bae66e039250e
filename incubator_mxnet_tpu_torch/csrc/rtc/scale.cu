// o = x * alpha: the port's twin of the Pallas kernel `scale_kernel`
// (tests/test_rtc.py:20), built and launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.  One
// multiply per element is far below the card's arithmetic rate.
//
// Design: a grid-stride loop, one element per thread per pass, so that
// the 32 threads of a warp touch 128 contiguous bytes (one coalesced
// transaction).  The wrapper caps the grid at the 8 blocks of 256
// threads an SM holds at once, so every block is resident and loops.  One
// rounding (x * alpha) on either side, so the kernel equals its plain
// version bit for bit.
__global__ void scale(const float* __restrict__ x, float* __restrict__ o,
                      float alpha, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = x[i] * alpha;
}
