"""The port's ``gluon.data`` (datasets, samplers, the DataLoader, the
vision datasets) against the JAX package's, on the CPU.

- ``DataLoader`` batches bit-equal to the JAX package's synchronous
  loader (``num_workers=0``) under the same numpy seed: the port's at
  ``num_workers=0``, in thread workers and in forked process workers
  (shared-memory batches), over an ``ArrayDataset`` with a lazy
  ``transform_first`` and over a ``RecordFileDataset`` that decodes
  JPEG records in the workers; every ``last_batch`` rule; resume by
  ``state_dict``/``load_state_dict`` mid-epoch.
- Process workers: a worker that dies has its batch re-dispatched (the
  epoch's batches stay whole and in order) within
  ``MXTPU_DATA_WORKER_RESTARTS``, and past it the loader raises
  ``DataPipelineError``; a worker that raises, or wedges past
  ``MXTPU_DATA_TIMEOUT``, raises it too; no ``/dev/shm`` segment is
  left behind.
- ``MNIST``, ``CIFAR10`` and ``ImageFolderDataset`` read files on disk
  the same way, and ``transforms`` give the same arrays.

The JAX package's process loader is not run here (its forked workers
can wait on a semaphore for good); every wait of the port's has a
deadline: ``MXTPU_DATA_TIMEOUT`` is 10 s in this file.
"""
import glob
import gzip
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.resilience import DataPipelineError  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

PKGS = {"jax": mx, "port": mt}
MODES = {"sync": dict(num_workers=0),
         "threads": dict(num_workers=3, thread_pool=True),
         "processes": dict(num_workers=3)}


@pytest.fixture(autouse=True)
def _bounded_waits(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "10")
    monkeypatch.setenv("MXTPU_DL_DEAD_GRACE", "2")


def _leftover_segments():
    return glob.glob(f"/dev/shm/mxtpu_dl_{os.getpid():x}_*")


def _as_numpy(batch):
    if isinstance(batch, (list, tuple)):
        return [_as_numpy(b) for b in batch]
    return batch.asnumpy() if hasattr(batch, "asnumpy") else \
        np.asarray(batch)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def _scale(x):
    return x * 2.0 + 1.0


def _array_dataset(M):
    rs = np.random.RandomState(0)
    x = rs.rand(23, 3, 5).astype(np.float32)
    y = np.arange(23, dtype=np.float32)
    return M.gluon.data.ArrayDataset(x, y).transform_first(_scale)


def _load(M, dataset, seed=5, **kw):
    np.random.seed(seed)
    loader = M.gluon.data.DataLoader(dataset, **kw)
    return [_as_numpy(b) for b in loader]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataloader_matches(mode, last_batch):
    kw = dict(batch_size=4, shuffle=True, last_batch=last_batch)
    ref = _load(mx, _array_dataset(mx), **kw)
    got = _load(mt, _array_dataset(mt), **kw, **MODES[mode])
    _equal(got, ref)
    assert not _leftover_segments()


def _decode_crop(record):
    """A record -> (a center-cropped HWC float image, its label)."""
    header, img = mt.recordio.unpack(record)
    arr = mt.image.imdecode(img).asnumpy()
    return arr[2:14, 3:15].astype(np.float32), np.float32(header.label)


def _jax_decode_crop(record):
    header, img = mx.recordio.unpack(record)
    arr = mx.image.imdecode(img).asnumpy()
    return arr[2:14, 3:15].astype(np.float32), np.float32(header.label)


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dl") / "r")
    rs = np.random.RandomState(1)
    w = mt.recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(19):
        img = (rs.rand(18, 20, 3) * 255).astype(np.uint8)
        w.write_idx(i, mt.recordio.pack_img(
            mt.recordio.IRHeader(0, float(i), i, 0), img))
    w.close()
    return path + ".rec"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_record_file_dataset_decoded_in_workers(rec_file, mode):
    kw = dict(batch_size=5, shuffle=True)
    ref = _load(mx, mx.gluon.data.RecordFileDataset(rec_file)
                .transform(_jax_decode_crop), **kw)
    got = _load(mt, mt.gluon.data.RecordFileDataset(rec_file)
                .transform(_decode_crop), **kw, **MODES[mode])
    _equal(got, ref)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataloader_resume(mode):
    kw = dict(batch_size=3, shuffle=True, **MODES[mode])
    np.random.seed(8)
    loader = mt.gluon.data.DataLoader(_array_dataset(mt), **kw)
    it = iter(loader)
    head = [_as_numpy(next(it)) for _ in range(3)]
    state = loader.state_dict()
    rest = [_as_numpy(b) for b in it]
    np.random.seed(123)                       # other seeds: restored
    other = mt.gluon.data.DataLoader(_array_dataset(mt), **kw)
    other.load_state_dict(state)
    assert other.state_dict()["batches_served"] == 3
    _equal([_as_numpy(b) for b in other], rest)
    ref = _load(mx, _array_dataset(mx), seed=8, batch_size=3, shuffle=True)
    _equal(head + rest, ref)
    with pytest.raises(ValueError, match="DataLoader"):
        other.load_state_dict({"type": "NDArrayIter"})


class _Dying(mt.gluon.data.Dataset):
    """Sample ``at`` kills its worker the first ``times`` times it is
    read (a marker file counts the deaths); ``raise_at`` raises."""

    def __init__(self, marker, at=7, times=1, raise_at=None, hang_at=None):
        self._marker, self._at, self._times = marker, at, times
        self._raise_at, self._hang_at = raise_at, hang_at

    def __len__(self):
        return 16

    def __getitem__(self, idx):
        if idx == self._raise_at:
            raise KeyError(f"sample {idx} is gone")
        if idx == self._hang_at:
            import time
            time.sleep(30)
        if idx == self._at:
            deaths = os.path.getsize(self._marker) \
                if os.path.exists(self._marker) else 0
            if deaths < self._times:
                with open(self._marker, "ab") as f:
                    f.write(b"x")
                os._exit(3)
        return np.full((2,), idx, np.float32)


@pytest.mark.parametrize("times,restarts", [(1, 2), (3, 2)])
def test_dead_worker_redispatch_and_budget(tmp_path, monkeypatch, times,
                                           restarts):
    monkeypatch.setenv("MXTPU_DATA_WORKER_RESTARTS", str(restarts))
    data = _Dying(str(tmp_path / "deaths"), times=times)
    loader = mt.gluon.data.DataLoader(data, batch_size=2, num_workers=2)
    if times <= restarts:
        with pytest.warns(RuntimeWarning, match="re-dispatching"):
            got = [b.asnumpy() for b in loader]
        np.testing.assert_array_equal(np.concatenate(got)[:, 0],
                                      np.arange(16, dtype=np.float32))
    else:
        with pytest.warns(RuntimeWarning), \
                pytest.raises(DataPipelineError,
                              match="MXTPU_DATA_WORKER_RESTARTS"):
            list(loader)
    assert not _leftover_segments()


@pytest.mark.parametrize("fault", ["raise", "hang"])
def test_worker_error_and_stall_are_typed(tmp_path, monkeypatch, fault):
    import time
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "1.5")
    data = _Dying(str(tmp_path / "d"), at=None,
                  raise_at=5 if fault == "raise" else None,
                  hang_at=5 if fault == "hang" else None)
    loader = mt.gluon.data.DataLoader(data, batch_size=2, num_workers=2)
    t0 = time.monotonic()
    with pytest.raises(DataPipelineError,
                       match="sample 5 is gone" if fault == "raise"
                       else "MXTPU_DATA_TIMEOUT"):
        list(loader)
    assert time.monotonic() - t0 < 8
    assert not _leftover_segments()


def test_samplers_match():
    S = {n: M.gluon.data for n, M in PKGS.items()}
    rnd = {}
    for n in PKGS:
        np.random.seed(2)
        rnd[n] = list(S[n].RandomSampler(10))
    assert rnd["port"] == rnd["jax"]
    for last in ("keep", "discard", "rollover"):
        outs = {}
        for n in PKGS:
            bs = S[n].BatchSampler(S[n].SequentialSampler(11), 4, last)
            outs[n] = [list(bs), list(bs), len(bs)]
        assert outs["port"] == outs["jax"]


def _write_mnist(root, n=12):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(3)
    imgs = (rs.rand(n, 28, 28) * 255).astype(np.uint8)
    lbls = rs.randint(0, 10, n).astype(np.uint8)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbls.tobytes())


def _write_cifar(root, n=5):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(4)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        raw = rs.randint(0, 256, (n, 3073)).astype(np.uint8)
        raw[:, 0] %= 10
        raw.tofile(os.path.join(root, name))


def test_vision_datasets_and_transforms_match(tmp_path):
    from PIL import Image
    _write_mnist(str(tmp_path / "mnist"))
    _write_cifar(str(tmp_path / "cifar"))
    rs = np.random.RandomState(6)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / cls)
        for i in range(3):
            Image.fromarray((rs.rand(9, 7, 3) * 255).astype(np.uint8)) \
                .save(tmp_path / "folder" / cls / f"{i}.png")
    out = {}
    for n, M in PKGS.items():
        v = M.gluon.data.vision
        tf = v.transforms.Compose([v.transforms.ToTensor(),
                                   v.transforms.Normalize((0.5, 0.4, 0.3),
                                                          (0.2, 0.2, 0.2))])
        mnist = v.MNIST(root=str(tmp_path / "mnist"))
        cifar = v.CIFAR10(root=str(tmp_path / "cifar"), train=True)
        cifar_t = v.CIFAR10(root=str(tmp_path / "cifar"), train=False,
                            transform=lambda d, l: (tf(d), l))
        folder = v.ImageFolderDataset(str(tmp_path / "folder"))
        out[n] = ([_as_numpy(mnist[i][0]) for i in (0, 11)]
                  + [mnist[3][1], len(mnist), len(cifar), len(cifar_t)]
                  + [_as_numpy(cifar[i][0]) for i in (0, 24)]
                  + [_as_numpy(cifar_t[4][0]), cifar_t[4][1]]
                  + [folder.items, folder.synsets])
    for a, b in zip(out["port"], out["jax"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    # the JAX package's ImageFolderDataset imports an ``image.imread``
    # its image package lacks; the port's decodes as PIL does
    folder = mt.gluon.data.vision.ImageFolderDataset(str(tmp_path /
                                                         "folder"))
    for i, (path, label) in enumerate(folder.items):
        img, lab = folder[i]
        np.testing.assert_array_equal(
            img.asnumpy(), np.asarray(Image.open(path).convert("RGB")))
        assert lab == label
