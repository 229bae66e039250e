#!/usr/bin/env python3
"""Time variants of the rtc ``addone`` kernel (``csrc/rtc/addone.cu``)
against ``torch.add(x, 1)`` on one NVIDIA card, in turns.

    python3 incubator_mxnet_tpu_torch/tools/addone_variants.py

Each variant is ``SOURCE`` below: the shipped kernel's tile walk with
another count of float4s a thread keeps in flight per pass (``VEC``;
the shipped kernel moves one, ``csrc/rtc/scale.cu`` four), with or
without the streaming hints (``__ldcs``/``__stcs`` replaced by plain
accesses), in blocks of another size, with enough blocks a tile to
cover it in one pass.  Every variant is held bit for bit against x + 1
at fp32 (8192, 4096); then each variant, the shipped kernel and
``torch.add`` are timed on the device's clock (chip_smoke.py's
``device_ms``, 20 calls a sample), five samples in turns.  Prints one
JSON object: the samples, and each median over ``torch.add``'s.  Run
from the repository root; exits non-zero without a CUDA card.
"""
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (float4s a thread a pass, streaming hints, threads a block)
VARIANTS = ((1, True, 128), (1, False, 256), (2, True, 128),
            (2, True, 256), (4, True, 256), (4, False, 256),
            (8, True, 256))
TURNS = 5

SOURCE = r"""
__global__ void addone(const float* __restrict__ x, float* __restrict__ o,
                       long long rows, long long cols) {
  const long long r0 = (long long)blockIdx.y * 8;
  const long long r1 = r0 + 8 < rows ? r0 + 8 : rows;
  const long long n = (r1 - r0) * cols;
  const float* __restrict__ xt = x + r0 * cols;
  float* __restrict__ ot = o + r0 * cols;
  long long done = 0;
  if (((reinterpret_cast<unsigned long long>(xt) |
        reinterpret_cast<unsigned long long>(ot)) & 15) == 0) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xt);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(ot);
    const long long n4 = n >> 2;
    const long long chunk = (long long)blockDim.x * VEC;
    for (long long c = (long long)blockIdx.x * chunk; c < n4;
         c += (long long)gridDim.x * chunk) {
      const long long i = c + threadIdx.x;
      float4 v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const long long j = i + (long long)k * blockDim.x;
        if (j < n4) v[k] = __ldcs(x4 + j);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const long long j = i + (long long)k * blockDim.x;
        if (j < n4) {
          v[k].x += 1.0f; v[k].y += 1.0f; v[k].z += 1.0f; v[k].w += 1.0f;
          __stcs(o4 + j, v[k]);
        }
      }
    }
    done = n4 << 2;
  }
  for (long long i = done + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    ot[i] = xt[i] + 1.0f;
}
"""


def variant(vec, hints, block):
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch import rtc_examples as ex
    text = f"#define VEC {vec}\n" + SOURCE
    if not hints:
        text = ("#define __ldcs(p) (*(p))\n"
                "#define __stcs(p, v) (*(p) = (v))\n") + text
    per_block = block * vec * 4
    return rtc.compile_kernel(
        text, "addone", ex._SPECS["addone"]["signature"],
        out_shape=ex._like, block=(block,), scalars=ex._rows_cols,
        grid=lambda a, **_: (
            max(1, math.ceil(ex.ROWS_PER_TILE * a.shape[1] / per_block)),
            math.ceil(a.shape[0] / ex.ROWS_PER_TILE)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("addone_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import rtc_examples as ex

    print(cs.card_line(), flush=True)
    x = torch.randn(cs.RTC_FULL, device="cuda")
    calls = {}
    shipped = ex.kernel("addone")
    if not torch.equal(shipped(x), x + 1.0):
        print("addone_variants: addone disagrees with x + 1",
              file=sys.stderr)
        return 1
    calls["shipped"] = lambda: shipped(x)
    for vec, hints, block in VARIANTS:
        fn = variant(vec, hints, block)
        name = f"vec{vec}_{'hints' if hints else 'plain'}_b{block}"
        if not torch.equal(fn(x), x + 1.0):
            print(f"addone_variants: {name} disagrees with x + 1",
                  file=sys.stderr)
            return 1
        calls[name] = lambda fn=fn: fn(x)
    calls["torch_add"] = lambda: torch.add(x, 1.0)
    ms = {k: [] for k in calls}
    for _ in range(TURNS):
        for name, fn in calls.items():
            ms[name].append(cs.device_ms(fn, torch, name))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    print(json.dumps({"shape": list(cs.RTC_FULL), "ms": ms,
                      "over_torch_add": {k: v / med["torch_add"]
                                         for k, v in med.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
