"""Which collectives a gloo group takes for CUDA tensors, on this host's
torch: two ranks on card 0, one fresh pair of processes per collective
(a collective that crashes its process cannot hide the next one).

    python incubator_mxnet_tpu_torch/tools/gloo_cuda_probe.py

Prints one line per collective (``ok``, ``FAIL <error>`` or the ranks'
exit codes, -11 for a segmentation fault; a crashing rank's Python stack
goes to stderr) and a last JSON line ``{collective: verdict}``.  The
collectives are torch.distributed's own, the functional ones
(``torch.distributed._functional_collectives``: what DTensor's
redistributions call) and DTensor redistributions themselves.  It
decides whether two ranks on one card can run a tensor-parallel step
(``parallel.ShardedTrainStep`` over a tp mesh) over gloo.  Needs a CUDA
card; exits 2 without one.
"""
import datetime
import faulthandler
import json
import os
import socket
import subprocess
import sys


def _ops(torch, dist, rank, world, dev):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    t = torch.ones(4, device=dev) * (rank + 1)
    x = torch.arange(16.0, device=dev).reshape(4, 4)
    half = x.chunk(world)[rank].contiguous()
    group = dist.group.WORLD

    def mesh():
        return DeviceMesh(dev.type, list(range(world)),
                          mesh_dim_names=("tp",))

    def gathered(out):
        return bool(torch.equal(out, x))

    return {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: gathered(
            _into(torch, dist, half, world)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=dev), t),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4, device=dev), t),
        "scatter": lambda: dist.scatter(
            torch.empty(4, device=dev),
            [t.clone() for _ in range(world)] if rank == 0 else None, 0),
        "funcol_all_reduce": lambda: float(
            funcol.all_reduce(t, "sum", group).sum()),
        "funcol_all_gather_tensor": lambda: gathered(
            funcol.all_gather_tensor(half, 0, group) + 0),
        "funcol_reduce_scatter_tensor": lambda: float(
            funcol.reduce_scatter_tensor(t, "sum", 0, group).sum()),
        "funcol_all_to_all_single": lambda: float(
            funcol.all_to_all_single(t, None, None, group).sum()),
        "device_mesh": lambda: mesh().ndim,
        "dtensor_from_local_shard_to_replicate": lambda: gathered(
            DTensor.from_local(half, mesh(), [Shard(0)], run_check=False)
            .redistribute(mesh(), [Replicate()]).to_local()),
        "dtensor_partial_to_replicate": lambda: bool(torch.equal(
            DTensor.from_local(x, mesh(), [Partial()], run_check=False)
            .redistribute(mesh(), [Replicate()]).to_local(), world * x)),
        "dtensor_partial_to_shard": lambda: bool(torch.equal(
            DTensor.from_local(x, mesh(), [Partial()], run_check=False)
            .redistribute(mesh(), [Shard(0)]).to_local(),
            world * half)),
        "dtensor_shard0_to_shard1": lambda: gathered(
            DTensor.from_local(half, mesh(), [Shard(0)], run_check=False)
            .redistribute(mesh(), [Shard(1)]).full_tensor()),
        "distribute_tensor_shard": lambda: bool(torch.equal(
            distribute_tensor(x, mesh(), [Shard(0)]).to_local(), half)),
    }


def _into(torch, dist, half, world):
    out = torch.empty((half.shape[0] * world,) + tuple(half.shape[1:]),
                      device=half.device)
    dist.all_gather_into_tensor(out, half)
    return out


def child(rank, port, op):
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    try:
        out = _ops(torch, dist, rank, 2, torch.device("cuda", 0))[op]()
        torch.cuda.synchronize()
        verdict = "ok" if out in (None, True) or not isinstance(out, bool) \
            else "WRONG"
    except Exception as exc:
        verdict = "FAIL " + " ".join(str(exc).split())[:160]
    print(json.dumps({"rank": rank, "op": op, "verdict": verdict}),
          flush=True)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))          # free on every local address
        return s.getsockname()[1]


def main():
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    names = ["all_reduce", "broadcast", "all_gather",
             "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "scatter", "funcol_all_reduce",
             "funcol_all_gather_tensor", "funcol_reduce_scatter_tensor",
             "funcol_all_to_all_single", "device_mesh",
             "dtensor_from_local_shard_to_replicate",
             "dtensor_partial_to_replicate", "dtensor_partial_to_shard",
             "dtensor_shard0_to_shard1", "distribute_tensor_shard"]
    verdicts = {}
    for op in names:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(r),
             str(port), op], stdout=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
        got = [json.loads(line)["verdict"] for out in outs
               for line in out.splitlines() if line.startswith("{")]
        rcs = [p.returncode for p in procs]
        verdict = got[0] if len(got) == 2 and len(set(got)) == 1 and \
            rcs == [0, 0] else f"ranks {got} exit codes {rcs}"
        verdicts[op] = verdict
        print(f"{op}: {verdict}", flush=True)
    print(json.dumps(verdicts), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit(main())
