"""The port's multi-process data service against the JAX package's:
batches bit-equal to the JAX ``DataServiceIter`` (plain, shuffled,
partial tail, random crop and mirror) at several worker counts, resume
across a change of worker count, supervision of a SIGKILLed worker and
its restart budget, the quarantine aggregated across shards, fault
points, remote shards over loopback (in-process, a JAX server, the
CLI in a subprocess) and a garbled frame that poisons one link only.

Images are small (48x48 crops of 64x64 JPEGs, B=8); every wait has a
short deadline and every service is closed by the ``services``
fixture."""
import io as _pyio
import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_mxnet_tpu import resilience as jres  # noqa: E402
from incubator_mxnet_tpu.data_service import (  # noqa: E402
    DataServiceIter as JaxService, RemoteShardServer as JaxServer)
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as pres  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry as ptel  # noqa: E402
from incubator_mxnet_tpu_torch import tracing as ptr  # noqa: E402
from incubator_mxnet_tpu_torch.data_service import (  # noqa: E402
    DataServiceIter, RemoteShardServer, ring as pring)
from incubator_mxnet_tpu_torch.resilience import (  # noqa: E402
    DataPipelineError)
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 48, 48)
B = 8


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "20")
    monkeypatch.setenv("MXTPU_DATA_HOST_GRACE", "3")
    monkeypatch.setenv("MXTPU_RPC_TIMEOUT", "10")
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    monkeypatch.delenv("MXTPU_DATA_REMOTE_ADDRS", raising=False)
    monkeypatch.delenv("MXTPU_MAX_BAD_RECORDS", raising=False)
    for r in (pres, jres):
        r.reset_faults()
    yield
    for r in (pres, jres):
        r.reset_faults()


@pytest.fixture
def services():
    """Every service a test opens is closed here, pass or fail."""
    opened = []

    def make(cls, prefix, W, **kw):
        kw.setdefault("preprocess_threads", 1)
        svc = cls(path_imgrec=prefix + ".rec", data_shape=SHAPE,
                  batch_size=B, num_workers=W, round_batch=True, **kw)
        opened.append(svc)
        return svc
    yield make
    for svc in opened:
        svc.close()


def _make_rec(prefix, n, edge=64, bad=()):
    from PIL import Image
    rio = mt.recordio
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rs = np.random.RandomState(3)
    for i in range(n):
        if i in bad:
            payload = b"\x00not-an-image" + bytes(
                rs.randint(0, 256, 64, dtype=np.uint8))
        else:
            gx = np.linspace(0, 255, edge, dtype=np.float32)
            img = (gx[None, :, None] * 0.4 + gx[:, None, None] * 0.4
                   + rs.rand(edge, edge, 3) * 50).astype(np.uint8)
            buf = _pyio.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=85)
            payload = buf.getvalue()
        rec.write_idx(i, rio.pack(rio.IRHeader(0, float(i % 7), i, 0),
                                  payload))
    rec.close()
    return prefix


@pytest.fixture(scope="module")
def rec48(tmp_path_factory):
    return _make_rec(str(tmp_path_factory.mktemp("pds48") / "ds"), 48)


@pytest.fixture(scope="module")
def rec44(tmp_path_factory):
    """A partial tail batch (pad 4 under round_batch)."""
    return _make_rec(str(tmp_path_factory.mktemp("pds44") / "ds"), 44)


def _np_batches(it, limit=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy().copy(),
                    b.label[0].asnumpy().copy(), b.pad))
        if limit is not None and len(out) == limit:
            break
    return out


def _assert_same(got, ref, what=""):
    assert len(got) == len(ref), (what, len(got), len(ref))
    for i, ((d, lb, p), (rd, rl, rp)) in enumerate(zip(got, ref)):
        assert p == rp, (what, i, p, rp)
        assert np.array_equal(d, rd), f"{what}: batch {i} data differs"
        assert np.array_equal(lb, rl), f"{what}: batch {i} label differs"


def _shm_orphans():
    """This process's ring segments still in /dev/shm."""
    return [f for f in os.listdir("/dev/shm")
            if f.startswith("mxtpu_ds_%x_" % os.getpid())]


# ----------------------------------------------------- bit-equal to JAX
CASES = [(W, v) for v in ("plain", "shuffled", "tail") for W in (1, 2, 3)]


@pytest.mark.parametrize("W,variant", CASES)
def test_batches_bit_equal_to_jax_service(services, rec48, rec44, W,
                                          variant):
    prefix = rec44 if variant == "tail" else rec48
    kw = {"shuffle": variant == "shuffled"}
    got = {}
    for name, cls in (("jax", JaxService), ("port", DataServiceIter)):
        np.random.seed(5)
        got[name] = _np_batches(services(cls, prefix, W, **kw))
    _assert_same(got["port"], got["jax"], f"{variant} W={W}")
    assert len(got["port"]) == 6
    if variant == "tail":
        assert got["port"][-1][2] == 4
    if variant == "plain":            # and the single-process iterator's
        ref = _np_batches(mt.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", data_shape=SHAPE, batch_size=B,
            preprocess_threads=1))
        _assert_same(got["port"], ref, "vs ImageRecordIter")


@pytest.mark.parametrize("W", [1, 3])
def test_random_crop_and_mirror_match_jax(services, rec48, W):
    got = {}
    for name, cls in (("jax", JaxService), ("port", DataServiceIter)):
        np.random.seed(11)
        got[name] = _np_batches(services(cls, rec48, W, rand_crop=True,
                                         rand_mirror=True, mean_r=123.68,
                                         mean_g=116.779, mean_b=103.939))
    _assert_same(got["port"], got["jax"], f"augmented W={W}")
    np.random.seed(11)
    one = _np_batches(services(DataServiceIter, rec48, 1, rand_crop=True,
                               rand_mirror=True, mean_r=123.68,
                               mean_g=116.779, mean_b=103.939))
    _assert_same(got["port"], one, f"W={W} vs W=1")


def test_worker_decode_builds_no_ndarray(services, rec48, monkeypatch):
    """The workers' PIL path runs the image module's numpy cores: with
    the NDArray maker broken (in the parent, so in every forked worker)
    the stream is unchanged."""
    from incubator_mxnet_tpu_torch.image import image as pimage
    monkeypatch.setenv("MXTPU_NATIVE_DECODE", "0")
    ref = _np_batches(services(DataServiceIter, rec48, 2))

    def broken(arr):
        raise AssertionError("a decode worker built an NDArray")
    monkeypatch.setattr(pimage, "nd_array", broken)
    svc = services(DataServiceIter, rec48, 2)
    assert not svc._decode["native"]
    _assert_same(_np_batches(svc), ref, "numpy-only workers")


# -------------------------------------------------------------- resume
@pytest.mark.parametrize("W,W_new", [(4, 3), (2, 1)])
def test_resume_reshards_worker_count(services, rec48, W, W_new):
    full = _np_batches(services(DataServiceIter, rec48, W))
    svc = services(DataServiceIter, rec48, W)
    head = _np_batches(svc, limit=3)
    state = svc.state_dict()
    jsvc = services(JaxService, rec48, W)
    _np_batches(jsvc, limit=3)
    jstate = jsvc.state_dict()
    assert {k: v for k, v in state.items() if k != "np_rng"} == \
        {k: v for k, v in jstate.items() if k != "np_rng"}
    resumed = services(DataServiceIter, rec48, W_new)
    resumed.load_state_dict(state)
    resumed.reset()                 # fit's epoch-start reset keeps it
    _assert_same(head + _np_batches(resumed), full, f"{W}->{W_new}")


# --------------------------------------------------------- supervision
def test_sigkill_worker_recovers_bit_identical(services, rec48,
                                               monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_WORKER_RESTARTS", "2")
    ref = _np_batches(services(DataServiceIter, rec48, 2))
    ptr.reset_for_tests()
    ptel.get_registry().reset()
    svc = services(DataServiceIter, rec48, 2, ring_depth=1)
    got = _np_batches(svc, limit=1)
    os.kill(svc._procs[1].pid, signal.SIGKILL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got += _np_batches(svc)
    _assert_same(got, ref, "after SIGKILL")
    assert svc._restarts == 1
    assert ptel.snapshot()["counters"][
        "data_service_worker_restarts_total"] == 1
    assert ptr.events("data_service_worker_dead")
    assert ptr.events("data_service_worker_restart")
    names = [r.name for r in svc._rings]
    svc.close()
    assert not set(names) & set(_shm_orphans())


def test_restart_budget_exhausted_raises_typed(services, rec48,
                                               monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_WORKER_RESTARTS", "0")
    svc = services(DataServiceIter, rec48, 2, ring_depth=1)
    svc.next()
    os.kill(svc._procs[0].pid, signal.SIGKILL)
    with pytest.raises(DataPipelineError, match="restart budget"):
        while True:
            svc.next()


@pytest.mark.parametrize("spec,err", [
    ("data_service:worker:1:error", DataPipelineError),
    ("data_service:ring:1:error", pres.TransientError)])
def test_fault_points_surface_typed(services, rec48, monkeypatch, spec,
                                    err):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", spec)
    pres.reset_faults()
    svc = services(DataServiceIter, rec48, 2)
    with pytest.raises(err):
        while True:
            svc.next()


def test_quarantine_aggregated_across_shards(services, tmp_path,
                                             monkeypatch):
    prefix = _make_rec(str(tmp_path / "bad"), 32, bad={1, 9})
    monkeypatch.setenv("MXTPU_MAX_BAD_RECORDS", "4")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = {n: _np_batches(services(c, prefix, 2))
               for n, c in (("jax", JaxService), ("port", DataServiceIter))}
        _assert_same(got["port"], got["jax"], "quarantine within budget")
        assert sum(B - p for _, _, p in got["port"]) == 30
        # one bad record per shard, budget 1 < 2 in aggregate
        monkeypatch.setenv("MXTPU_MAX_BAD_RECORDS", "1")
        with pytest.raises(DataPipelineError, match="2 corrupt"):
            _np_batches(services(DataServiceIter, prefix, 2))


def test_ring_that_does_not_fit_fails_typed(monkeypatch):
    class Tiny:
        f_bavail, f_frsize, f_blocks = 10, 4096, 100
    monkeypatch.setattr(pring.os, "statvfs", lambda root: Tiny())
    import multiprocessing as _mp
    with pytest.raises(DataPipelineError, match="does not fit"):
        pring.ShmBatchRing(B, SHAPE, 1, 4, _mp.get_context("fork"))
    assert not _shm_orphans()


def test_stats_telemetry_and_device_prefetch(services, rec48):
    ptel.get_registry().reset()
    ref = _np_batches(services(DataServiceIter, rec48, 1))
    svc = services(DataServiceIter, rec48, 2)
    it = mt.io.DevicePrefetchIter(svc, ctx=mt.cpu())
    _assert_same(_np_batches(it), ref, "DevicePrefetchIter(service)")
    st = svc.stats()
    assert st["restarts"] == 0 and st["img_per_sec"] > 0
    assert [st["shards"][w]["delivered"] for w in (0, 1)] == [3, 3]
    c = ptel.snapshot()["counters"]
    assert c["data_service_batches_total"] == 12


# ------------------------------------------------------- remote shards
@pytest.mark.parametrize("server", ["port", "jax"])
def test_remote_shard_over_loopback_bit_identical(services, rec48, server):
    ref = _np_batches(services(DataServiceIter, rec48, 3))
    srv = (RemoteShardServer if server == "port" else JaxServer)(
        host="127.0.0.1", port=0, max_shards=2).start()
    try:
        svc = services(DataServiceIter, rec48, 3,
                       remote_addrs=[f"127.0.0.1:{srv.port}"])
        got = _np_batches(svc)
        st = svc.stats()
        svc.close()
    finally:
        srv.close()
    _assert_same(got, ref, f"remote via {server} server")
    assert st["remote_shards"] == 1 and st["restarts"] == 0


def test_garbled_frame_poisons_one_link_only(services, rec48, monkeypatch):
    ref = _np_batches(services(DataServiceIter, rec48, 3))
    srv = RemoteShardServer(host="127.0.0.1", port=0, max_shards=2).start()
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "data_service:net:2:corrupt")
    pres.reset_faults()
    ptel.get_registry().reset()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            svc = services(DataServiceIter, rec48, 3,
                           remote_addrs=[f"127.0.0.1:{srv.port}"])
            got = _np_batches(svc)
            st = svc.stats()
            svc.close()
    finally:
        srv.close()
    assert st["restarts"] == 1 and st["remote_shards"] == 1
    _assert_same(got, ref, "garbled frame")
    assert ptel.snapshot()["counters"][
        "data_service_net_restarts_total"] == 1


def test_remote_server_cli_takes_the_last_shard(services, rec48,
                                                tmp_path):
    ref = _np_batches(services(DataServiceIter, rec48, 2), limit=4)
    pf = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.data_service.net",
         "--shards", "1", "--port-file", pf], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(pf):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        port = int(open(pf).read())
        svc = services(DataServiceIter, rec48, 2,
                       remote_addrs=[f"127.0.0.1:{port}"])
        got = _np_batches(svc, limit=4)
        assert svc.stats()["remote_shards"] == 1
        svc.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    _assert_same(got, ref, "CLI remote shard")
