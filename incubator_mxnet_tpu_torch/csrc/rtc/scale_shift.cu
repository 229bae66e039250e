// o = x * alpha + beta: the port's twin of the Pallas kernel
// `scale_shift_kernel` (tools/flash_compile_check.py:90), built and
// launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.
//
// Design: a grid-stride loop as in scale.cu.  nvcc contracts the
// multiply-add into one FMA, which rounds once where the plain version
// rounds twice, so the two may differ by an ulp of the terms (the check
// allows 2 ulp of |x * alpha| + |beta|).
__global__ void scale_shift(const float* __restrict__ x,
                            float* __restrict__ o, float alpha, float beta,
                            long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = x[i] * alpha + beta;
}
