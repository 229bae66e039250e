"""The port's kvstore and mesh (incubator_mxnet_tpu_torch.kvstore,
parallel.mesh) against the JAX package's, on the CPU with the same numpy
inputs.

- ``KVStore``: init, push (replicas summed, bitwise), pull, the updater
  and the store-side optimizer (within fp32 rtol 1e-6), optimizer-state
  files (CRC32) round-tripped and read by the other package's store,
  ``row_sparse_pull`` into a dense array, ``create``'s names and errors;
  a store over two processes joins the world (no coordinator: raises).
- The twins of ``tests/test_metric_io.py``'s kvstore tests.
- ``make_mesh`` / ``use_mesh`` / ``current_mesh``: the axes, the
  nesting, the JAX package's ``ValueError`` texts; a mesh over more than
  one device in one process places nothing (raises when used).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import parallel as tpar  # noqa: E402

CPU = mt.cpu()


def _arr(M, a):
    return M.nd.array(a) if M is mx else M.nd.array(a, ctx=CPU)


def _vals(seed, n, shape=(3, 5)):
    rs = np.random.RandomState(seed)
    return [rs.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------- twins of test_metric_io
def test_kvstore_local():
    for M in (mx, mt):
        kv = M.kvstore.create("local")
        kv.init(3, _arr(M, np.ones((2, 2), "f4")))
        kv.push(3, [_arr(M, np.ones((2, 2), "f4")),
                    _arr(M, np.ones((2, 2), "f4")) * 2])
        out = _arr(M, np.zeros((2, 2), "f4"))
        kv.pull(3, out=out)
        np.testing.assert_allclose(out.asnumpy(), 3 * np.ones((2, 2)))


def test_kvstore_updater_path():
    for M in (mx, mt):
        kv = M.kvstore.create("local")
        kv.init("w", _arr(M, np.ones(3, "f4")))
        kv.set_optimizer(M.optimizer.create("sgd", learning_rate=0.5))
        kv.push("w", _arr(M, np.ones(3, "f4")))
        out = _arr(M, np.zeros(3, "f4"))
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), np.ones(3) - 0.5)


def test_kvstore_dist_async_rejected():
    for M in (mx, mt):
        with pytest.raises(ValueError) as err:
            M.kvstore.create("dist_async")
        assert "dist_async" in str(err.value)
    with pytest.raises(ValueError, match="unknown kvstore type"):
        mt.kvstore.create("p2p")


# ---------------------------------------------- against the JAX store
@pytest.mark.parametrize("name", ["local", "device", "tpu", "dist_sync",
                                  "nccl"])
def test_create_names_match(name):
    j, t = mx.kvstore.create(name), mt.kv.create(name)
    assert (t.type, t.rank, t.num_workers) == (j.type, j.rank,
                                               j.num_workers)
    t.barrier()
    t.send_command_to_servers(0, "")


def test_push_sums_replicas_bitwise():
    """A key's replicas are summed in order in fp32: the same bits as the
    JAX store's sum; list keys push and pull together."""
    reps = _vals(0, 4)
    got = {}
    for M in (mx, mt):
        kv = M.kvstore.create("device")
        kv.init([5, 6], [_arr(M, np.zeros((3, 5), "f4"))] * 2)
        kv.push([5, 6], [[_arr(M, r) for r in reps],
                         [_arr(M, r) for r in reps[:2]]])
        outs = [_arr(M, np.zeros((3, 5), "f4")) for _ in range(2)]
        kv.pull([5, 6], out=outs)
        got[M] = [o.asnumpy() for o in outs]
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="not initialized"):
        mt.kv.create("local").pull(9, out=_arr(mt, np.zeros(2, "f4")))


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01))])
def test_store_side_optimizer_matches_jax(opt, kw, tmp_path):
    """set_optimizer: three pushes of two replicas each update the
    stored weight as the JAX store's do (rtol 1e-6); the optimizer state
    saved by either store loads into the other, and the next update
    agrees."""
    w0 = _vals(1, 1)[0]
    grads = _vals(2, 8)
    stores, paths = {}, {}
    for M in (mx, mt):
        kv = M.kvstore.create("local")
        kv.init("w", _arr(M, w0))
        kv.set_optimizer(M.optimizer.create(opt, rescale_grad=0.5, **kw))
        for i in range(3):
            kv.push("w", [_arr(M, grads[2 * i]), _arr(M, grads[2 * i + 1])])
        out = _arr(M, np.zeros_like(w0))
        kv.pull("w", out=out)
        stores[M] = (kv, out.asnumpy())
        paths[M] = str(tmp_path / f"{'jax' if M is mx else 'port'}.states")
        kv.save_optimizer_states(paths[M])
    np.testing.assert_allclose(stores[mt][1], stores[mx][1], rtol=1e-6,
                               atol=1e-7)
    import os
    assert os.path.exists(paths[mt] + ".crc32")
    # each store takes the other's state, then one more push agrees
    after = {}
    for M, other in ((mx, mt), (mt, mx)):
        kv = stores[M][0]
        kv.load_optimizer_states(paths[other])
        kv.push("w", _arr(M, grads[7]))
        out = _arr(M, np.zeros_like(w0))
        kv.pull("w", out=out)
        after[M] = out.asnumpy()
    np.testing.assert_allclose(after[mt], after[mx], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="no updater"):
        mt.kv.create("local").save_optimizer_states(paths[mt])


def test_set_updater_and_gradient_pull():
    """A custom updater sees (key, merged grad, stored weight); with no
    updater, pull hands back the merged gradient."""
    seen = []
    kv = mt.kv.create("local")
    kv.init(0, _arr(mt, np.ones(4, "f4")))
    kv.set_updater(lambda k, g, w: seen.append((k, g.asnumpy(),
                                                w.asnumpy())))
    kv.push(0, [_arr(mt, np.full(4, 2, "f4"))] * 2)
    assert seen[0][0] == 0
    np.testing.assert_array_equal(seen[0][1], np.full(4, 4, "f4"))
    plain = mt.kv.create("local")
    plain.init(1, _arr(mt, np.zeros(2, "f4")))
    plain.push(1, [_arr(mt, np.ones(2, "f4"))] * 3)
    out = _arr(mt, np.zeros(2, "f4"))
    plain.pull(1, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(2, 3, "f4"))


def test_row_sparse_pull_dense_matches_jax():
    w = _vals(3, 1, (6, 4))[0]
    rows = np.array([4, 1, 4], np.int32)
    got = {}
    for M in (mx, mt):
        kv = M.kvstore.create("local")
        kv.init("e", _arr(M, w))
        out = _arr(M, np.zeros_like(w))
        kv.row_sparse_pull("e", out=out, row_ids=M.nd.array(rows)
                           if M is mx else M.nd.array(rows, ctx=CPU))
        got[M] = out.asnumpy()
    np.testing.assert_array_equal(got[mt], got[mx])
    assert not got[mt][0].any() and (got[mt][4] == w[4]).all()


def test_multi_process_store_raises(monkeypatch):
    """Two workers without a coordinator: the JAX package's error (the
    store joins the world through dist.init)."""
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.delenv("MXTPU_COORD_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="no MXTPU_COORD_ADDR"):
        mt.kvstore.create("dist_sync")


# ------------------------------------------------------------- mesh
def test_make_mesh_axes_and_errors_match_jax():
    for dp, kw in ((None, {}), (1, dict(tp=1, pp=1))):
        j = jpar.make_mesh(dp, devices=jax.devices("cpu")[:1], **kw)
        t = tpar.make_mesh(dp, devices=["cpu"], **kw)
        assert t.axis_names == tuple(j.axis_names) == tpar.AXES
        assert t.shape == dict(j.shape)
        assert t.device == torch.device("cpu")
    for n, kw in ((1, dict(dp=2)), (3, dict(tp=2)), (2, dict(dp=1, sp=4))):
        errs = []
        for make, devs in ((jpar.make_mesh, jax.devices("cpu")[:n]),
                           (tpar.make_mesh, ["cpu"] * n)):
            with pytest.raises(ValueError) as err:
                make(devices=devs, **kw)
            errs.append(str(err.value))
        assert errs[0] == errs[1], errs
    two = tpar.make_mesh(devices=["cpu", "cpu"])
    assert two.shape["dp"] == 2
    with pytest.raises(NotImplementedError, match="one process"):
        two.device


def test_use_mesh_nesting():
    outer = tpar.make_mesh(devices=["cpu"])
    inner = tpar.make_mesh(1, devices=["cpu"])
    assert tpar.current_mesh() is None
    with tpar.use_mesh(outer) as m:
        assert m is outer and tpar.current_mesh() is outer
        with tpar.use_mesh(inner):
            assert tpar.current_mesh() is inner
        assert tpar.current_mesh() is outer
    assert tpar.current_mesh() is None
    with pytest.raises(RuntimeError):
        with tpar.use_mesh(outer):
            raise RuntimeError("unwinds")
    assert tpar.current_mesh() is None


def test_shardings_match_jax_specs():
    j = jpar.make_mesh(devices=jax.devices("cpu")[:1])
    t = tpar.make_mesh(devices=["cpu"])
    for args in ((3,), (3, 0, 1), (2, 1)):
        assert tuple(tpar.shard_batch(t, *args).spec) == \
            tuple(jpar.shard_batch(j, *args).spec)
    assert tuple(tpar.replicated(t).spec) == tuple(jpar.replicated(j).spec)
    assert tuple(tpar.named_sharding(t, "dp", None).spec) == \
        tuple(jpar.named_sharding(j, "dp", None).spec)
    assert tpar.P("dp", None) == ("dp", None)
    with pytest.raises(ValueError, match="not in the mesh"):
        tpar.named_sharding(t, "zz")
