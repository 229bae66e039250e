#!/usr/bin/env python3
"""Hold this tree's TransformerLM host paths against another checkout's
on one NVIDIA card, in turns.

    python3 incubator_mxnet_tpu_torch/tools/compare_layers.py --parent DIR

DIR is the root of another checkout of the repository (for instance
``git archive <commit> | tar -x -C DIR``).  In a fresh process for each
of DIR, this tree, this tree and DIR, it builds the TransformerLM at
bench.py's width (vocab 32000, d_model 1024, 12 layers, 16 heads,
max_len 1024; Xavier weights from seed 0) on the card and prints one
JSON line: ``generate``'s decode ms per token (4 prompts of 128 tokens;
33 new tokens less 1, over 32) and bench.py's bf16 Adam train step ms
(B=8 x L=1024, 2 warm-up and 8 timed steps).  Both paths are
host-bound, so the turns show what the layers' host cost does to them.
Exits non-zero without a CUDA card or if a run fails.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = r'''
import json, sys, time
import torch
sys.path.insert(0, ".")
import incubator_mxnet_tpu_torch as mt
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
    TransformerLM
torch.backends.cuda.matmul.allow_tf32 = False
net = TransformerLM(32000, d_model=1024, n_layers=12, n_heads=16,
                    max_len=1024, device="cuda")
mt.initializer.initialize(net, mt.initializer.Xavier(),
                          mt.random.generator(0))
gen = torch.Generator().manual_seed(1)
prompt = torch.randint(0, 32000, (4, 128), generator=gen).cuda()
with torch.inference_mode():
    net.generate(prompt, max_new_tokens=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.generate(prompt, max_new_tokens=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    net.generate(prompt, max_new_tokens=33)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
decode_ms = ((t2 - t1) - (t1 - t0)) / 32 * 1e3
step = mt.parallel.ShardedTrainStep(
    net, "adam", dict(learning_rate=1e-4), compute_dtype=torch.bfloat16)
toks = torch.randint(0, 32000, (8, 1024), generator=gen).cuda()
for _ in range(2):
    step(toks, toks)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(8):
    step(toks, toks)
torch.cuda.synchronize()
step_ms = (time.perf_counter() - t0) / 8 * 1e3
print(json.dumps({"decode_ms_per_token": decode_ms,
                  "bf16_step_ms": step_ms}))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    for tree, name in ((args.parent, "parent"), (REPO, "change"),
                       (REPO, "change"), (args.parent, "parent")):
        run = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        rec["tree"] = name
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
