"""One rank of the port's elastic twin (``__graft_entry__.
_dryrun_elastic_cpu`` on processes): not a pytest module;
``tests/test_torch_sharded_checkpoint.py`` spawns four of it.

    python tests/torch_elastic_worker.py RANK WORKDIR

World A (4 ranks, dp=2 x tp=2) runs the uninterrupted reference, a
ZeRO step (its generation restored into the plain layout), Megatron tp
on a TransformerLM against one process's step, and the first k1 steps,
then saves; world B (ranks 0 and 1, dp=1 x tp=2: the
world SHRUNK) restores, checks the restore bit for bit, runs to k2 and
saves; world C (4 ranks again: GROWN) restores, checks, and finishes.
Each world is a fresh ``dist.init`` after ``dist.shutdown``, on a port
that rank 0 picks just before its join and publishes as
WORKDIR/port-<world> (a port picked at spawn time could be taken by
another socket on the host before the world binds it).  Inputs
(weights, batches) come from WORKDIR/inputs.npz; rank 0 writes
WORKDIR/result.json and the saved trees as WORKDIR/tree_<k>.npz.  Any
failure prints its traceback and exits 1.
"""
import json
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

K1, K2 = 4, 6
PORT_WAIT_S = 150       # a rank waits this long for rank 0's port file


def build(mt, mesh, inp, zero=False):
    from incubator_mxnet_tpu_torch.parallel import (P, ShardedTrainStep,
                                                    ShardingRules)
    net = mt.gluon.nn.HybridSequential(prefix="elck_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(32, activation="relu", in_units=16),
                mt.gluon.nn.Dense(4, in_units=32))
    net.initialize(ctx=mt.cpu())
    params = net.collect_params()
    for name in ("dense0_weight", "dense0_bias", "dense1_weight",
                 "dense1_bias"):
        params["elck_" + name].set_data(
            mt.nd.array(inp[name], ctx=mt.cpu()))
    rules = ShardingRules([
        (r"dense0_weight$", P("tp", None)),
        (r"dense0_bias$", P("tp")),
        (r"dense1_weight$", P(None, "tp")),
    ])
    return ShardedTrainStep(net, optimizer="adam",
                            optimizer_params=dict(learning_rate=1e-3),
                            mesh=mesh, rules=rules, zero=zero)


LM_RULES = [(r"qkv\.weight$", ("tp", None)), (r"qkv\.bias$", ("tp",)),
            (r"proj\.weight$", (None, "tp")), (r"up\.weight$", ("tp", None)),
            (r"up\.bias$", ("tp",)), (r"down\.weight$", (None, "tp")),
            (r"head\.weight$", ("tp", None)),
            (r"embed\.weight$", ("tp", None))]


def lm_check(mt, mesh):
    """Megatron tp on the port's TransformerLM (qkv, up and the head
    column-parallel, proj and down row-parallel, the vocab split) at
    dp x tp against one process's step on the whole batch, SGD: the
    losses, every parameter after 3 steps, and the count of attention
    calls that took the DTensor route (one a layer a step)."""
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    from incubator_mxnet_tpu_torch.ops import flash
    from incubator_mxnet_tpu_torch.parallel import (P, ShardedTrainStep,
                                                    ShardingRules, make_mesh)

    def model():
        net = TransformerLM(64, d_model=32, n_layers=2, n_heads=4,
                            max_len=16, device="cpu")
        return mt.initializer.initialize(net, mt.initializer.Xavier(),
                                         mt.random.generator(0))

    def loss(outs, y):
        logits = outs[0].float()
        picked = logits.gather(-1, y.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - picked).mean()

    rs = np.random.RandomState(1)
    toks = rs.randint(0, 64, (4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    kw = dict(optimizer="sgd", loss_fn=loss,
              optimizer_params=dict(learning_rate=0.1, momentum=0.9))
    ref = ShardedTrainStep(model(), mesh=make_mesh(devices=["cpu"]), **kw)
    ref_losses = [float(ref(toks, labels)) for _ in range(3)]
    calls = []
    route = flash._flash_dtensor

    def counted(*a):
        calls.append(1)
        return route(*a)

    flash._flash_dtensor = counted
    try:
        step = ShardedTrainStep(model(), mesh=mesh, rules=ShardingRules(
            [(pat, P(*spec)) for pat, spec in LM_RULES]), **kw)
        losses = [float(step(toks, labels)) for _ in range(3)]
    finally:
        flash._flash_dtensor = route
    step.write_back()
    err = max(float((p.detach() - ref.params[n].detach()).abs().max())
              for n, p in step.block.named_parameters())
    return {"lm_losses": losses, "lm_ref_losses": ref_losses,
            "lm_param_err": err, "lm_sharded": len(step._sharded),
            "lm_dtensor_attention_calls": len(calls)}


def rules_check(mesh):
    """``apply_rules`` with the default rules lays an up projection out
    column-parallel (this rank's rows over tp, whole again when
    gathered) and leaves a name no rule matches as it is; ``constrain``
    to the replicated spec gathers it.  Returns the local shapes."""
    import torch
    from incubator_mxnet_tpu_torch.parallel import (constrain,
                                                    tp_rules_for_dense_stacks)
    from incubator_mxnet_tpu_torch.parallel.sharding import apply_rules
    w, b = torch.arange(32.0).reshape(8, 4), torch.ones(3)
    laid = apply_rules(mesh, {"blk_up_weight": w, "norm_gamma": b},
                       tp_rules_for_dense_stacks())
    assert laid["norm_gamma"] is b
    assert torch.equal(laid["blk_up_weight"].full_tensor(), w)
    whole = constrain(laid["blk_up_weight"], mesh)
    assert torch.equal(whole.to_local(), w)
    return {"up_local_shape": list(laid["blk_up_weight"].to_local().shape),
            "constrained_local_shape": list(whole.to_local().shape)}


def full_tree(step):
    """The step's checkpoint tree as whole numpy arrays (every rank
    gathers: a collective)."""
    from incubator_mxnet_tpu_torch.parallel.checkpoint import _flatten
    from torch.distributed.tensor import DTensor
    out = {}
    for key, leaf in _flatten(step._ckpt_tree()):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        out[key] = leaf.detach().cpu().numpy()
    return out


def assert_bitwise(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), (what, k)


def coordinator_port(rank, workdir, world_name):
    path = os.path.join(workdir, f"port-{world_name}")
    if rank == 0:
        with socket.socket() as s:
            s.bind(("", 0))             # free on every local address
            port = s.getsockname()[1]
        with open(path + ".part", "w") as f:
            f.write(str(port))
        os.replace(path + ".part", path)
        return port
    deadline = time.time() + PORT_WAIT_S
    while not os.path.exists(path):
        assert time.time() < deadline, f"no port for world {world_name}"
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def join(mt, rank, world, workdir, world_name):
    port = coordinator_port(rank, workdir, world_name)
    mt.dist.init(coordinator_address=f"localhost:{port}",
                 num_workers_=world, rank_=rank)
    assert mt.dist.num_workers() == world and mt.dist.rank() == rank
    assert mt.dist.backend(world) == "gloo"


def main():
    rank, workdir = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    import incubator_mxnet_tpu_torch as mt
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    xs, ys = inp["xs"], inp["ys"]
    ckdir = os.path.join(workdir, "ck")
    result = {}

    # world A: the uninterrupted reference, then k1 steps and a save
    join(mt, rank, 4, workdir, "a")
    mesh_a = make_mesh(dp=2, tp=2)
    ref = build(mt, mesh_a, inp)
    result["ref_losses"] = [float(ref(xs[i], ys[i]))
                            for i in range(len(xs))]
    # ZeRO: dense1_bias (tp-replicated) sharded over dp, same losses;
    # its generation restores into the plain layout bit for bit
    z = build(mt, mesh_a, inp, zero=True)
    assert z._zero_names == ["elck_dense1_bias"], z._zero_names
    zl = [float(z(xs[i], ys[i])) for i in range(3)]
    assert np.allclose(zl, result["ref_losses"][:3], rtol=1e-6), zl
    z.save_checkpoint(os.path.join(workdir, "zero"))
    zp = build(mt, mesh_a, inp)
    zp.load_checkpoint(os.path.join(workdir, "zero"))
    assert_bitwise(full_tree(zp), full_tree(z), "zero restore")
    result["zero_losses"] = zl
    result.update(lm_check(mt, mesh_a))
    result["rules"] = rules_check(mesh_a)
    a = build(mt, mesh_a, inp)
    losses = [float(a(xs[i], ys[i])) for i in range(K1)]
    a.save_checkpoint(ckdir)
    src = full_tree(a)
    # the collectives of dist, on the joined world
    got = mt.dist.allreduce_sum({"v": torch.full((3,), float(rank))})
    assert got["v"].tolist() == [6.0] * 3
    assert float(mt.dist.allreduce_max(torch.tensor(float(rank)))) == 3.0
    assert float(mt.dist.broadcast(torch.tensor(float(rank) + 7))) == 7.0
    mt.dist.barrier("elastic_a")
    mt.dist.shutdown()
    mt.dist.shutdown()              # reentrant

    if rank < 2:
        # world B: SHRUNK to dp=1 x tp=2
        join(mt, rank, 2, workdir, "b")
        b = build(mt, make_mesh(dp=1, tp=2), inp)
        b.load_checkpoint(ckdir)
        assert_bitwise(full_tree(b), src, "shrink restore")
        losses += [float(b(xs[i], ys[i])) for i in range(K1, K2)]
        b.save_checkpoint(ckdir)
        src2 = full_tree(b)
        if rank == 0:
            np.savez(os.path.join(workdir, "tree_b.npz"), **src2)
        mt.dist.shutdown()

    # world C: GROWN back to dp=2 x tp=2
    join(mt, rank, 4, workdir, "c")
    c = build(mt, make_mesh(dp=2, tp=2), inp)
    c.load_checkpoint(ckdir)
    tree_c = full_tree(c)
    src2 = dict(np.load(os.path.join(workdir, "tree_b.npz")))
    assert_bitwise(tree_c, src2, "grow restore")
    tail = [float(c(xs[i], ys[i])) for i in range(K2, len(xs))]
    if rank < 2:
        losses += tail
    else:
        losses = None
    mt.dist.shutdown()
    if rank == 0:
        result["losses"] = losses
        result["gens"] = sorted(p for p in os.listdir(ckdir)
                                if p.startswith("gen-"))
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(result, f)
    print(f"ELASTIC_OK rank {rank}", flush=True)


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
