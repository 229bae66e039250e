// o = x * alpha: the port's twin of the Pallas kernel `scale_kernel`
// (tests/test_rtc.py:20), built and launched through rtc.compile_kernel
// (incubator_mxnet_tpu_torch/rtc_examples.py).
//
// Bound: bytes.  At the full-width shape, fp32 (8192, 4096), it reads
// 134 MB and writes 134 MB: 0.080 ms at the H100 SXM's 3.35 TB/s.  One
// multiply per element is far below the card's arithmetic rate.
//
// Design: 16-byte accesses with several in flight per thread.  Each
// pass a block takes SCALE_VEC * blockDim.x float4s: thread t loads the
// float4s t, t + blockDim.x, ... (a warp reads 512 contiguous bytes per
// load), issues all SCALE_VEC loads before it stores any, so 64 bytes
// per thread are in flight, then multiplies and stores them.  Loads
// and stores carry the streaming, evict-first hints (__ldcs, __stcs):
// the 268 MB of traffic is five times the 50 MB L2, so nothing is
// reused.  The wrapper's grid (rtc_examples._scale_grid) covers the
// array once, one pass per block, as addone's does; the loop over
// passes keeps any smaller grid correct.  The two grid shapes on an
// H100 80GB HBM3 at 700 W, fp32 (8192, 4096), device time, medians of
// three turns (chip_smoke.py, rtc_scale_turns): one pass 0.0913 ms, a
// resident grid that loops (132 SMs x 8 blocks of 256) 0.0961, and
// torch.mul 0.0903 in the same process.  1, 2, 4 or 8 float4s a
// thread, with or without the hints, in blocks of 128 to 512 threads,
// all land within 1% of torch.mul there (tools/scale_variants.py): the
// kernel runs at the card's copy rate.
//
// x or o not 16-byte aligned (a flat view sliced at an odd offset is a
// legal input): the whole array goes through the scalar loop instead.
// The n % 4 tail always does.  One rounding per element, x * alpha, on
// either path, so the kernel equals its plain version bit for bit.
#define SCALE_VEC 4

__global__ void scale(const float* __restrict__ x, float* __restrict__ o,
                      float alpha, long long n) {
  const long long threads = (long long)gridDim.x * blockDim.x;
  long long done = 0;     // elements the vector path covered
  if (((reinterpret_cast<unsigned long long>(x) |
        reinterpret_cast<unsigned long long>(o)) & 15) == 0) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(o);
    const long long n4 = n >> 2;
    const long long chunk = (long long)blockDim.x * SCALE_VEC;
    for (long long c = (long long)blockIdx.x * chunk; c < n4;
         c += (long long)gridDim.x * chunk) {
      const long long i = c + threadIdx.x;
      float4 v[SCALE_VEC];
      if (c + chunk <= n4) {
#pragma unroll
        for (int k = 0; k < SCALE_VEC; ++k)
          v[k] = __ldcs(x4 + i + (long long)k * blockDim.x);
#pragma unroll
        for (int k = 0; k < SCALE_VEC; ++k) {
          v[k].x *= alpha; v[k].y *= alpha;
          v[k].z *= alpha; v[k].w *= alpha;
          __stcs(o4 + i + (long long)k * blockDim.x, v[k]);
        }
      } else {                          // the last, partial chunk
#pragma unroll
        for (int k = 0; k < SCALE_VEC; ++k) {
          const long long j = i + (long long)k * blockDim.x;
          if (j < n4) {
            float4 w = __ldcs(x4 + j);
            w.x *= alpha; w.y *= alpha; w.z *= alpha; w.w *= alpha;
            __stcs(o4 + j, w);
          }
        }
      }
    }
    done = n4 << 2;
  }
  for (long long i = done + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += threads)
    o[i] = x[i] * alpha;
}
