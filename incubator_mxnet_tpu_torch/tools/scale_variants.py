#!/usr/bin/env python3
"""Time variants of the rtc ``scale`` kernel (``csrc/rtc/scale.cu``)
against ``torch.mul`` on one NVIDIA card, in turns.

    python3 incubator_mxnet_tpu_torch/tools/scale_variants.py

Each variant is the source with another count of float4s a thread moves
per pass (``SCALE_VEC``), with or without the streaming hints
(``__ldcs``/``__stcs`` replaced by plain accesses), in blocks of another
size, on a grid that covers the array in one pass.  Every variant is
held bit for bit against x * alpha at fp32 (8192, 4096); then each
variant and ``torch.mul`` are timed on the device's clock
(chip_smoke.py's ``device_ms``, 20 calls a sample), three samples in
turns.  Prints one JSON object: the samples, and each median over
``torch.mul``'s.  Run from the repository root; exits non-zero without a
CUDA card.
"""
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (float4s a thread a pass, streaming hints, threads a block)
VARIANTS = ((4, True, 256), (2, True, 256), (8, True, 256),
            (4, False, 256), (4, True, 512), (4, True, 128),
            (1, True, 256))
TURNS = 3


def variant(src, vec, hints, block):
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch import rtc_examples as ex
    text = src.replace("#define SCALE_VEC 4", f"#define SCALE_VEC {vec}")
    if not hints:
        text = ("#define __ldcs(p) (*(p))\n"
                "#define __stcs(p, v) (*(p) = (v))\n") + text
    per_block = block * vec * 4
    return rtc.compile_kernel(
        text, "scale", ex._SPECS["scale"]["signature"], out_shape=ex._like,
        block=(block,), scalars=ex._numel,
        grid=lambda a, **_: (max(1, math.ceil(a.numel() / per_block)),))


def main():
    import torch
    if not torch.cuda.is_available():
        print("scale_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import rtc_examples as ex

    print(cs.card_line(), flush=True)
    src = (ex.SOURCES / "scale.cu").read_text()
    x = torch.randn(cs.RTC_FULL, device="cuda")
    calls = {}
    for vec, hints, block in VARIANTS:
        fn = variant(src, vec, hints, block)
        name = f"vec{vec}_{'hints' if hints else 'plain'}_b{block}"
        if not torch.equal(fn(x, alpha=1.7), x * 1.7):
            print(f"scale_variants: {name} disagrees with x * alpha",
                  file=sys.stderr)
            return 1
        calls[name] = lambda fn=fn: fn(x, alpha=1.7)
    calls["torch_mul"] = lambda: torch.mul(x, 1.7)
    ms = {k: [] for k in calls}
    for _ in range(TURNS):
        for name, fn in calls.items():
            ms[name].append(cs.device_ms(fn, torch, name))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    print(json.dumps({"shape": list(cs.RTC_FULL), "ms": ms,
                      "over_torch_mul": {k: v / med["torch_mul"]
                                         for k, v in med.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
