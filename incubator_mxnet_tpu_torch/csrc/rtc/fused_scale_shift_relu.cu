// o = max(alpha * x + beta, 0): the port's twin of the Pallas kernel
// `fused_scale_shift_relu_kernel` (examples/custom_pallas_kernel.py:27),
// built and launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).  Its gradient is the
// example's VJP, g * (y > 0) * alpha, in plain ops.
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.  This
// is the point of the fusion: one pass over memory instead of three.
//
// Design: a grid-stride loop as in scale.cu.  nvcc contracts
// x * alpha + beta into one FMA, which rounds once where the plain
// version rounds twice, so the two may differ by an ulp of the terms
// (the check allows 2 ulp of |x * alpha| + |beta|).  A NaN stays NaN,
// as in the plain version's relu.
__global__ void fused_scale_shift_relu(const float* __restrict__ x,
                                       float* __restrict__ o, float alpha,
                                       float beta, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = x[i] * alpha + beta;
    o[i] = v < 0.0f ? 0.0f : v;
  }
}
