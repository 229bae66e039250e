"""One worker of the port's multi-process kvstore check, run under the
launcher (the reference's single-machine dist trick,
tests/nightly/dist_sync_kvstore.py via tools/launch.py -n 2):

    python tools/launch.py -n 2 -- python \\
        incubator_mxnet_tpu_torch/tools/dist_worker_check.py

The launcher's env (MXTPU_NUM_WORKERS, MXTPU_WORKER_RANK,
MXTPU_COORD_ADDR) joins the world through ``kvstore.create``; the
worker checks the store's broadcast init, the allreduced push with and
without an updater, the barrier, ``Module.fit`` and a Gluon ``Trainer``
over ``dist_sync`` (the replicas end equal), the guard's allreduce-max,
and a dp=2 ``ShardedTrainStep`` against one process's step on the
global batch.  Each rank prints ``DIST_OK rank <r>``; a failure prints
its traceback and exits 1.  It runs on the host (``MXTPU_FORCE_CPU``
is set by the caller on a machine with cards).
"""
import os
import sys
import traceback

import numpy as np
import torch


def _same_everywhere(mt, flat):
    got = mt.dist.allreduce_sum(torch.from_numpy(flat)).numpy()
    assert np.allclose(got, mt.dist.num_workers() * flat, rtol=1e-6), \
        np.abs(got - 2 * flat).max()


def _kvstore(mt, r):
    cpu = mt.cpu()
    kv = mt.kvstore.create("dist_sync")
    assert kv.num_workers == 2 and kv.rank == r, (kv.num_workers, kv.rank)
    assert mt.dist.backend() == "gloo"
    # init: rank 0's value wins everywhere
    kv.init(3, mt.nd.array(np.full((4,), r + 10.0, np.float32), ctx=cpu))
    out = mt.nd.zeros((4,), ctx=cpu)
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), 10.0), out.asnumpy()
    # push sums over the workers (no updater: pull the merged gradient)
    kv.push(3, mt.nd.array(np.full((4,), float(r + 1), np.float32),
                           ctx=cpu))
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), 3.0), out.asnumpy()
    # updater: every worker applies the same summed gradient
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                         rescale_grad=1.0))
    kv.push(3, mt.nd.array(np.full((4,), float(r + 1), np.float32),
                           ctx=cpu))
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), 9.7), out.asnumpy()
    kv.barrier()


def _module_fit(mt, r):
    rs = np.random.RandomState(0)     # the same data, sharded by rank
    x = rs.rand(128, 10).astype(np.float32)
    w = rs.rand(10, 5).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.float32)
    it = mt.io.NDArrayIter(x[r::2], y[r::2], batch_size=16,
                           label_name="softmax_label")
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, name="fc", num_hidden=5)
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mt.random.seed(0)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.fit(it, num_epoch=2, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(learning_rate=0.5),
            initializer=mt.initializer.Xavier())
    arg, _ = mod.get_params()
    flat = np.concatenate([v.asnumpy().ravel()
                           for _, v in sorted(arg.items())])
    assert np.all(np.isfinite(flat))
    _same_everywhere(mt, flat)


def _trainer(mt, r):
    cpu = mt.cpu()
    mt.random.seed(1)
    net = mt.gluon.nn.Dense(3, in_units=6)
    net.initialize(mt.initializer.Xavier(), ctx=cpu)
    # rank 1 starts elsewhere: the store's init broadcasts rank 0's
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(learning_rate=0.1),
                               kvstore="dist_sync")
    rs = np.random.RandomState(10 + r)
    loss_fn = mt.gluon.loss.L2Loss()
    for _ in range(3):
        x = mt.nd.array(rs.rand(4, 6).astype(np.float32), ctx=cpu)
        with mt.autograd.record():
            loss = loss_fn(net(x), mt.nd.zeros((4, 3), ctx=cpu))
        loss.backward()
        trainer.step(8)
    assert trainer._fused is False       # per parameter, push reduces
    flat = np.concatenate([p.data().asnumpy().ravel()
                           for p in net.collect_params().values()])
    _same_everywhere(mt, flat)


def _guard(mt, r):
    from incubator_mxnet_tpu_torch import optimizer as opt_mod

    class Guard:
        pass
    g = Guard()
    opt_mod.accumulate_window(g, torch.tensor(r == 0))  # rank 1 is bad
    assert opt_mod.read_window_bad(g) == 1


def _step_dp2(mt, r):
    """dp=2 over the two ranks, each taking its half of the global
    batch, against one process's step on the whole batch."""
    from incubator_mxnet_tpu_torch.parallel import (ShardedTrainStep,
                                                    make_mesh)

    def net():
        mt.random.seed(2)
        n = mt.gluon.nn.HybridSequential(prefix="dp2_")
        with n.name_scope():
            n.add(mt.gluon.nn.Dense(8, activation="relu", in_units=6),
                  mt.gluon.nn.Dense(3, in_units=8))
        n.initialize(mt.initializer.Xavier(), ctx=mt.cpu())
        return n
    rs = np.random.RandomState(3)
    xs = rs.rand(3, 8, 6).astype(np.float32)
    ys = rs.randint(0, 3, (3, 8)).astype(np.int32)
    mesh = make_mesh()
    assert mesh.shape["dp"] == 2 and mesh.spans_world
    two = ShardedTrainStep(net(), "adam", dict(learning_rate=1e-2),
                           mesh=mesh)
    one = ShardedTrainStep(net(), "adam", dict(learning_rate=1e-2),
                           mesh=make_mesh(devices=["cpu"]))
    for x, y in zip(xs, ys):
        a, b = float(two(x, y)), float(one(x, y))
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    for n in two.params:
        np.testing.assert_allclose(two.params[n].detach().numpy(),
                                   one.params[n].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def main():
    torch.set_num_threads(1)
    import incubator_mxnet_tpu_torch as mt
    r = int(os.environ["MXTPU_WORKER_RANK"])
    _kvstore(mt, r)
    _module_fit(mt, r)
    _trainer(mt, r)
    _guard(mt, r)
    _step_dp2(mt, r)
    mt.dist.barrier("dist_worker_check")
    print(f"DIST_OK rank {r}", flush=True)
    mt.dist.shutdown()


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
