"""The port's image pipeline (``image/``) and its iterators (``io``'s
``PrefetchingIter`` and ``DevicePrefetchIter``) against the JAX
package's, on the CPU, over small JPEG records (16 x 16 to 40 x 30
pixels, a few dozen records) written by the port's ``recordio``.

- ``ImageRecordIter`` batches bit-equal to the JAX package's under the
  same ``np.random``/``random`` seeds: plain, shuffled with random crop
  and mirror (one preprocess thread: the JAX package's pool threads draw
  in a racing order), normalized, ``round_batch`` wrap and not,
  ``num_parts``, multi-label, through the native decoder and through
  PIL; the bad-record quarantine within its budget (equal batches) and
  beyond it (``DataPipelineError`` in both).
- The port's resume: ``state_dict`` mid-epoch and ``skip`` replay the
  rest of the epoch exactly, under shuffle, random crops and
  quarantine, at several preprocess threads.
- ``ImageIter`` (over a .rec, and over a .lst of files) and
  ``ImageDetIter`` (with the detection augmenters) bit-equal.
- ``PrefetchingIter`` resumes by ``state_dict`` and raises a typed error
  within ``MXTPU_DATA_TIMEOUT`` when its source wedges;
  ``DevicePrefetchIter`` raises without a card and keeps the resume
  protocol on a ``cpu()`` context.

Every wait on a producer thread is bounded: ``MXTPU_DATA_TIMEOUT`` is
10 s in this file.
"""
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import resilience as jres  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.resilience import DataPipelineError  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

PKGS = {"jax": mx, "port": mt}
N_RECORDS = 27
SHAPE = (3, 16, 16)


@pytest.fixture(autouse=True)
def _bounded_waits(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "10")


def _image(rs, h, w, smooth):
    if smooth:
        base = rs.rand(3, 3, 3) * 255
        return np.asarray(np.kron(base, np.ones((h // 3 + 1, w // 3 + 1,
                                                 1)))[:h, :w],
                          np.uint8)
    return (rs.rand(h, w, 3) * 255).astype(np.uint8)


def _write_rec(path, n, labels_of, bad=(), size=(16, 40)):
    """``n`` JPEG records of random sizes (with .idx); the records in
    ``bad`` hold bytes that are no image."""
    rio = mt.recordio
    rs = np.random.RandomState(11)
    w = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(n):
        h, wd = rs.randint(size[0], size[1] + 1, 2)
        hdr = rio.IRHeader(0, labels_of(i), i, 0)
        if i in bad:
            w.write_idx(i, rio.pack(hdr, b"\xff\xd8 not a jpeg"))
        else:
            w.write_idx(i, rio.pack_img(hdr, _image(rs, h, wd, i % 3 == 0),
                                        quality=90))
    w.close()
    return path + ".rec"


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("image")
    return {
        "plain": _write_rec(str(d / "plain"), N_RECORDS,
                            lambda i: float(i % 5)),
        "multi": _write_rec(str(d / "multi"), 11,
                            lambda i: [float(i), i / 2.0, 1.0]),
        "bad": _write_rec(str(d / "bad"), N_RECORDS,
                          lambda i: float(i % 5), bad=(4, 9, 17)),
    }


def _batches(it, limit=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if limit is not None and len(out) == limit:
            break
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def _record_iter(M, path, seed=1, **kw):
    np.random.seed(seed)
    random.seed(seed + 1)
    kw.setdefault("batch_size", 4)
    kw.setdefault("data_shape", SHAPE)
    return M.io.ImageRecordIter(path_imgrec=path, **kw)


CASES = {
    "plain": dict(),
    "augmented": dict(shuffle=True, rand_crop=True, rand_mirror=True,
                      preprocess_threads=1),
    "normalized": dict(rand_mirror=True, mean_r=123.0, mean_g=117.0,
                       mean_b=104.0, std_r=58.0, std_g=57.0, std_b=57.5,
                       preprocess_threads=1),
    "no_round_batch": dict(round_batch=False, batch_size=5),
    "part": dict(num_parts=2, part_index=1, shuffle=True),
    "resized": dict(resize=20, rand_crop=True, preprocess_threads=1),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches(recs, monkeypatch, case, native):
    if not native:
        monkeypatch.setenv("MXTPU_NATIVE_DECODE", "0")
    elif case == "plain":
        assert mt.image.native_dec.available(), mt.image.native_dec.why()
    got = {n: _batches(_record_iter(M, recs["plain"], **CASES[case]))
           for n, M in PKGS.items()}
    _equal(got["port"], got["jax"])
    count = N_RECORDS - N_RECORDS // 2 if case == "part" else N_RECORDS
    assert got["port"][-1][2] == -count % CASES[case].get("batch_size", 4)


def test_image_record_iter_multi_label_and_decoder_record(recs):
    got = {n: _batches(_record_iter(M, recs["multi"], label_width=3))
           for n, M in PKGS.items()}
    _equal(got["port"], got["jax"])
    assert got["port"][0][1].shape == (4, 3)
    it = _record_iter(mt, recs["multi"], rand_crop=True)
    _batches(it)
    assert it.decoder_counts == {"native": 0, "pil": 3}
    assert it.last_decoder == "pil"


@pytest.mark.parametrize("budget", [3, 1])
def test_quarantine_within_and_beyond_budget(recs, monkeypatch, budget):
    monkeypatch.setenv("MXTPU_MAX_BAD_RECORDS", str(budget))
    if budget >= 3:
        got = {}
        for n, M in PKGS.items():
            with pytest.warns(RuntimeWarning, match="corrupt record"):
                got[n] = _batches(_record_iter(M, recs["bad"],
                                               **CASES["augmented"]))
        _equal(got["port"], got["jax"])
        assert sum(4 - b[2] for b in got["port"]) == N_RECORDS - 3
        return
    for M, err in ((mt, DataPipelineError), (mx, jres.DataPipelineError)):
        with pytest.warns(RuntimeWarning), \
                pytest.raises(err, match="MXTPU_MAX_BAD_RECORDS"):
            _batches(_record_iter(M, recs["bad"]))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("path,case", [("plain", "augmented"),
                                       ("bad", "augmented"),
                                       ("plain", "normalized")])
def test_resume_by_state_dict_and_skip(recs, monkeypatch, path, case,
                                       threads):
    monkeypatch.setenv("MXTPU_MAX_BAD_RECORDS", "100")  # over epochs
    kw = dict(CASES[case], preprocess_threads=threads)
    with pytest.warns() if path == "bad" else _no_warning():
        it = _record_iter(mt, recs[path], **kw)
        start = it.state_dict()
        head = _batches(it, limit=3)
        mid = it.state_dict()
        rest = _batches(it)
        it.reset()                       # a second epoch: a new shuffle
        second = _batches(it)
        # resume mid-epoch in a fresh iterator, from other seeds
        other = _record_iter(mt, recs[path], seed=99, **kw)
        other.load_state_dict(mid)
        other.reset()                    # fit's epoch-start reset keeps it
        _equal(_batches(other), rest)
        other.reset()
        _equal(_batches(other), second)
        # the epoch's start, then skip() past the delivered batches
        again = _record_iter(mt, recs[path], seed=7, **kw)
        again.load_state_dict(start)
        again.skip(3)
        _equal(_batches(again), rest)
        again.load_state_dict(start)
        _equal(_batches(again), head + rest)
    if threads == 1 and path == "plain":
        ref = _batches(_record_iter(mx, recs[path], **kw))
        _equal(head + rest, ref)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_image_iter_matches(recs, tmp_path):
    kw = dict(batch_size=4, data_shape=SHAPE, shuffle=True)
    for source in ("rec", "lst"):
        if source == "rec":
            paths = dict(path_imgrec=recs["plain"])
        else:
            rs = np.random.RandomState(5)
            with open(tmp_path / "imgs.lst", "w") as f:
                for i in range(9):
                    name = f"im{i}.jpg"
                    from PIL import Image
                    Image.fromarray(_image(rs, 20 + i, 24, i % 2)).save(
                        tmp_path / name, quality=90)
                    f.write(f"{i}\t{i % 3}\t{name}\n")
            paths = dict(path_imglist=str(tmp_path / "imgs.lst"),
                         path_root=str(tmp_path))
        got = {}
        for n, M in PKGS.items():
            random.seed(3)
            np.random.seed(3)
            augs = M.image.CreateAugmenter(SHAPE, resize=18, rand_crop=True,
                                           rand_mirror=True, mean=True,
                                           std=True, brightness=0.2)
            got[n] = _batches(M.image.ImageIter(aug_list=augs, **paths,
                                                **kw))
        _equal(got["port"], got["jax"])


def _det_rec(path, n=14):
    rio = mt.recordio
    rs = np.random.RandomState(2)
    w = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(n):
        objs = []
        for _ in range(1 + i % 3):
            x0, y0 = rs.uniform(0, 0.6, 2)
            objs += [float(i % 2), x0, y0, x0 + rs.uniform(0.2, 0.4),
                     y0 + rs.uniform(0.2, 0.4)]
        label = np.asarray([2, 5] + objs, np.float32)
        img = _image(rs, 30 + i, 36, i % 2)
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0), img))
    w.close()
    return path + ".rec"


@pytest.mark.parametrize("augment", [False, True])
def test_image_det_iter_matches(tmp_path, augment):
    path = _det_rec(str(tmp_path / "det"))
    got = {}
    for n, M in PKGS.items():
        random.seed(4)
        np.random.seed(4)
        augs = M.image.CreateDetAugmenter(
            (3, 24, 24), rand_crop=0.5 if augment else 0,
            rand_pad=0.5 if augment else 0, rand_mirror=augment,
            mean=np.array([1.0, 2.0, 3.0]), std=np.array([2.0, 2, 2]))
        got[n] = _batches(M.image.ImageDetIter(
            4, (3, 24, 24), path_imgrec=path, shuffle=True, aug_list=augs))
    _equal(got["port"], got["jax"])
    assert got["port"][0][1].shape == (4, 3, 5)


# --------------------------------------------------------------- iterators
def _array_iter(M, n=40, batch=4, seed=0):
    x = np.arange(n * 6, dtype=np.float32).reshape(n, 6)
    y = np.arange(n, dtype=np.float32)
    if M is mt:
        return mt.io.NDArrayIter(x, y, batch_size=batch, shuffle=True,
                                 seed=seed)
    return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)


def _rows(batches):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in batches]


def test_prefetching_iter_resume_and_matches(recs):
    ref = _batches(_record_iter(mx, recs["plain"], **CASES["normalized"]))
    pf = mt.io.PrefetchingIter(
        _record_iter(mt, recs["plain"], **CASES["normalized"]))
    head = [pf.next() for _ in range(3)]
    state = pf.state_dict()
    rest = list(pf)
    _equal([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in head + rest], ref)
    other = mt.io.PrefetchingIter(
        _record_iter(mt, recs["plain"], seed=5, **CASES["normalized"]))
    other.load_state_dict(state)
    _equal([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in other], [(b.data[0].asnumpy(), b.label[0].asnumpy(),
                               b.pad) for b in rest])


class _Wedged(mt.io.DataIter):
    """An iterator whose second batch never comes (until released)."""

    def __init__(self):
        super().__init__(2)
        self.release = threading.Event()
        self.calls = 0

    def next(self):
        self.calls += 1
        if self.calls > 1:
            self.release.wait(10)
            raise StopIteration
        x = mt.nd.array(np.zeros((2, 3), np.float32), ctx=mt.cpu())
        return mt.io.DataBatch([x], [x])


@pytest.mark.parametrize("kind", ["prefetching", "device_prefetch"])
def test_wedged_source_raises_within_the_data_timeout(monkeypatch, kind):
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "0.6")
    src = _Wedged()
    it = mt.io.PrefetchingIter(src) if kind == "prefetching" else \
        mt.io.DevicePrefetchIter(src, ctx=mt.cpu())
    it.next()
    t0 = time.monotonic()
    with pytest.raises(DataPipelineError, match="MXTPU_DATA_TIMEOUT"):
        it.next()
    assert time.monotonic() - t0 < 5
    src.release.set()


def test_worker_errors_are_typed():
    class Broken(mt.io.DataIter):
        def next(self):
            raise KeyError("disk gone")
    for it in (mt.io.PrefetchingIter(Broken(1)),
               mt.io.DevicePrefetchIter(Broken(1), ctx=mt.cpu())):
        with pytest.raises(DataPipelineError, match="disk gone"):
            it.next()
        with pytest.raises(DataPipelineError):
            it.next()


def test_device_prefetch_iter_needs_a_card_and_resumes_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.io.DevicePrefetchIter(_array_iter(mt))
    ref = _rows(_array_iter(mt))
    for depth in (1, 3):
        it = mt.io.DevicePrefetchIter(_array_iter(mt), ctx=mt.cpu(),
                                      depth=depth)
        head = _rows([it.next() for _ in range(4)])
        state = it.state_dict()
        assert state["delivered"] == 4 and state["type"] == \
            "DevicePrefetchIter"
        rest = _rows(it)
        for (a, b), (c, d) in zip(head + rest, ref):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        other = mt.io.DevicePrefetchIter(_array_iter(mt, seed=9),
                                         ctx=mt.cpu(), depth=depth)
        other.load_state_dict(state)
        for (a, b), (c, d) in zip(_rows(other), rest):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    monkeypatch.setenv("MXTPU_DEVICE_PREFETCH_DEPTH", "5")
    assert mt.io.DevicePrefetchIter(_array_iter(mt),
                                    ctx=mt.cpu())._depth == 5


def test_host_tensors_pass_through_uncopied():
    """A batch on the staging device crosses without a copy: ``.to`` of
    a tensor already on the device is the tensor (the executor binds
    batches so), and the cpu() stage hands the batch's own tensors on."""
    x = torch.zeros(3)
    assert x.to(torch.device("cpu")) is x
    src = _array_iter(mt)
    batch = src.next()
    src.reset()
    staged, event = mt.io.DevicePrefetchIter(
        _array_iter(mt), ctx=mt.cpu())._stage(batch)
    assert event is None
    assert staged.data[0]._data is batch.data[0]._data
    assert staged.label[0]._data is batch.label[0]._data


def test_data_service_iter_names_the_next_slice(recs):
    """``io.DataServiceIter`` is the data service's class in both
    packages: the same arguments it lacks raise, and on a record file
    it gives the same first batch."""
    for M in (mx, mt):
        with pytest.raises(TypeError, match="path_imgrec"):
            M.io.DataServiceIter()
    firsts = []
    for M in (mx, mt):
        it = M.io.DataServiceIter(recs["plain"], SHAPE, 8, num_workers=1)
        try:
            assert type(it).__module__ == \
                M.__name__ + ".data_service.service"
            firsts.append(_batches(it, limit=1))
        finally:
            it.close()
    _equal(firsts[0], firsts[1])


def _tiny_net(S):
    x = S.Convolution(S.Variable("data"), num_filter=4, kernel=(3, 3),
                      name="c0")
    x = S.Pooling(S.Activation(x, act_type="relu"), global_pool=True,
                  pool_type="avg", kernel=(1, 1))
    x = S.FullyConnected(S.Flatten(x), num_hidden=5, name="f0")
    return S.SoftmaxOutput(x, name="softmax")


def _fit_losses(train, weights):
    mod = mt.mod.Module(_tiny_net(mt.sym), context=mt.cpu())
    mod.bind(data_shapes=[("data", (4,) + SHAPE)],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={k: v.copy() for k, v in weights.items()})
    losses = []

    def on_batch(param):
        y = param.locals["data_batch"].label[0].asnumpy().astype(int)
        p = mod.get_outputs()[0].asnumpy()
        losses.append(-np.log(p[np.arange(len(y)), y]).mean())
    mod.fit(train, num_epoch=1, batch_end_callback=on_batch,
            optimizer="sgd", optimizer_params=dict(learning_rate=0.1))
    return losses


def test_fit_from_the_pipeline_matches_prestaged_batches(recs):
    """The CPU twin of chip_smoke's (iii) gate: fit over
    DevicePrefetchIter(ImageRecordIter) (fit resets the fresh iterator
    first, which keeps its untouched epoch) gives the losses of fit
    over the same batches drawn beforehand."""
    drawn = _batches(_record_iter(mt, recs["plain"], **CASES["augmented"]))
    rs = np.random.RandomState(0)
    weights = {"c0_weight": rs.normal(0, 0.1, (4, 3, 3, 3)),
               "c0_bias": np.zeros(4), "f0_weight": rs.normal(0, 0.1, (5, 4)),
               "f0_bias": np.zeros(5)}
    weights = {k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
               for k, v in weights.items()}
    x = np.concatenate([d for d, _, _ in drawn])
    y = np.concatenate([lb for _, lb, _ in drawn])
    ref = _fit_losses(mt.io.NDArrayIter(x, y, batch_size=4), weights)
    piped = _fit_losses(mt.io.DevicePrefetchIter(
        _record_iter(mt, recs["plain"], **CASES["augmented"]),
        ctx=mt.cpu()), weights)
    assert len(piped) == len(drawn) and piped == ref
