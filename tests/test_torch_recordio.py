"""The port's RecordIO (``recordio.py``) and record sharding
(``io/sharding.py``) against the JAX package's, on the CPU.

- Files written by either package, with either backend (the native
  library built from ``src/recordio/recordio.cc``, or Python's
  ``struct``), are byte for byte the same, and each package reads the
  other's records back exactly: payloads holding the record magic
  (split records), empty and odd-length payloads, scalar and
  multi-label headers.
- ``pack_img``/``unpack_img`` give the same bytes and pixels.
- ``resync`` past a corrupt region lands both packages on the same
  record; a pickled writer appends and does not truncate; a forked
  child reading through a parent's open reader does not move the
  parent's position.
- ``shard_range``, ``shard_keys``, ``assigned_batches`` and
  ``reshard_batch_cursors`` agree with the JAX package's on a grid.
"""
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu.io import sharding as jshard  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.io import sharding as tshard  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

PKGS = {"jax": mx, "port": mt}
MAGIC = b"\x0a\x23\xd7\xce"


def _backend(monkeypatch, name, kind):
    """Force package ``name``'s recordio onto backend ``kind``."""
    if kind == "python":
        monkeypatch.setattr(PKGS[name].recordio, "_native_lib",
                            lambda: None)
    return PKGS[name].recordio


def _records():
    rs = np.random.RandomState(7)
    out = [b"", b"x", MAGIC, b"ab" + MAGIC + b"cd" + MAGIC,
           MAGIC + MAGIC + b"\x00"]
    for n in (1, 3, 4, 5, 1023, 4096):
        out.append(rs.randint(0, 256, n).astype(np.uint8).tobytes())
    return out


def _headers():
    return [(0, 1.5, 3, 0), (0, [1.0, 2.0, 3.5], 9, 4),
            (0, np.arange(7, dtype=np.float32), 2, 1)]


def _write(rio, path, records, headers):
    w = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i, buf in enumerate(records):
        w.write_idx(i, buf)
    for j, (flag, label, id_, id2) in enumerate(headers):
        w.write_idx(len(records) + j,
                    rio.pack(rio.IRHeader(flag, label, id_, id2),
                             b"payload" * j))
    w.close()


@pytest.mark.parametrize("kinds", [("native", "native"),
                                   ("python", "python"),
                                   ("native", "python")])
def test_files_are_byte_equal_and_read_across(tmp_path, monkeypatch,
                                              kinds):
    writer_kind, reader_kind = kinds
    recs, hdrs = _records(), _headers()
    if writer_kind == "native":
        assert mt.recordio.backend_name() == "native"
    for name in PKGS:
        with monkeypatch.context() as m:
            _write(_backend(m, name, writer_kind),
                   str(tmp_path / name), recs, hdrs)
    for ext in (".rec", ".idx"):
        assert (tmp_path / f"jax{ext}").read_bytes() == \
            (tmp_path / f"port{ext}").read_bytes()
    for writer, reader in (("jax", "port"), ("port", "jax")):
        with monkeypatch.context() as m:
            rio = _backend(m, reader, reader_kind)
            base = str(tmp_path / writer)
            r = rio.MXIndexedRecordIO(base + ".idx", base + ".rec", "r")
            got = [r.read_idx(k) for k in r.keys]
            r.close()
            seq = rio.MXRecordIO(base + ".rec", "r")
            streamed = []
            while True:
                buf = seq.read()
                if buf is None:
                    break
                streamed.append(buf)
            seq.close()
        assert got[:len(recs)] == recs and streamed == got
        for buf, (_, label, id_, id2) in zip(got[len(recs):], hdrs):
            h, _ = mt.recordio.unpack(buf)
            hj, _ = mx.recordio.unpack(buf)
            np.testing.assert_array_equal(np.asarray(h.label),
                                          np.asarray(label, np.float32))
            assert (h.flag, h.id, h.id2) == (hj.flag, id_, id2)
            np.testing.assert_array_equal(h.label, hj.label)


def test_pack_img_unpack_img_match(tmp_path):
    rs = np.random.RandomState(3)
    img = (rs.rand(30, 40, 3) * 255).astype(np.uint8)
    for label in (2.0, [1.0, 0.25, 0.5, 0.75, 1.0]):
        hdr = (0, label, 5, 0)
        for fmt, q in ((".jpg", 95), (".png", 3), (".jpg", 80)):
            a = mt.recordio.pack_img(mt.recordio.IRHeader(*hdr), img,
                                     quality=q, img_fmt=fmt)
            b = mx.recordio.pack_img(mx.recordio.IRHeader(*hdr), img,
                                     quality=q, img_fmt=fmt)
            assert a == b
            for iscolor in (-1, 0, 1):
                (ha, ia), (hb, ib) = (mt.recordio.unpack_img(a, iscolor),
                                      mx.recordio.unpack_img(b, iscolor))
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_array_equal(ha.label, hb.label)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_resync_past_a_corrupt_region(tmp_path, monkeypatch, kind):
    recs = [bytes([i]) * (37 + i) for i in range(8)]
    path = str(tmp_path / "c.rec")
    w = mt.recordio.MXRecordIO(path, "w")
    offsets = []
    for buf in recs:
        offsets.append(w.tell())
        w.write(buf)
    w.close()
    raw = bytearray(open(path, "rb").read())
    raw[offsets[3]:offsets[3] + 4] = b"\xde\xad\xbe\xef"   # bad magic
    raw[offsets[5] + 2] ^= 0xFF                             # bad length
    open(path, "wb").write(bytes(raw))

    def scan(name):
        with monkeypatch.context() as m:
            rio = _backend(m, name, kind)
            r = rio.MXRecordIO(path, "r")
            seen, errors = [], 0
            while True:
                try:
                    buf = r.read()
                except IOError:
                    errors += 1
                    if r.resync() is None:
                        break
                    continue
                if buf is None:
                    break
                seen.append(buf)
            r.close()
        return seen, errors

    port, jax_ = scan("port"), scan("jax")
    assert port == jax_
    assert port[0][:3] == recs[:3] and port[0][-1] == recs[-1]


def test_pickled_writer_appends(tmp_path):
    path = str(tmp_path / "p.rec")
    w = mt.recordio.MXIndexedRecordIO(str(tmp_path / "p.idx"), path, "w")
    w.write_idx(0, b"first")
    clone = pickle.loads(pickle.dumps(w))
    clone.write_idx(1, b"second")
    clone.close()
    w.close()
    r = mt.recordio.MXIndexedRecordIO(str(tmp_path / "p.idx"), path, "r")
    assert sorted(r.keys) == [0, 1]
    assert [r.read_idx(k) for k in (0, 1)] == [b"first", b"second"]


def _child_reads(reader, out):
    out.put([reader.read_idx(k) for k in (3, 1)])


@pytest.mark.parametrize("kind", ["native", "python"])
def test_forked_child_keeps_the_parents_position(tmp_path, monkeypatch,
                                                kind):
    recs = [bytes([65 + i]) * 5000 for i in range(6)]
    base = str(tmp_path / "f")
    with monkeypatch.context() as m:
        rio = _backend(m, "port", kind)
        _write(rio, base, recs, [])
        reader = rio.MXIndexedRecordIO(base + ".idx", base + ".rec", "r")
        assert reader.read() == recs[0]
        ctx = multiprocessing.get_context("fork")
        out = ctx.Queue()
        proc = ctx.Process(target=_child_reads, args=(reader, out))
        proc.start()
        got = out.get(timeout=10)
        proc.join(timeout=10)
        assert not proc.is_alive() and proc.exitcode == 0
        assert got == [recs[3], recs[1]]
        assert [reader.read() for _ in range(5)] == recs[1:]


def test_sharding_matches():
    for n in (0, 1, 7, 100, 101):
        for parts in (1, 2, 3, 8):
            for k in range(parts):
                assert tshard.shard_range(n, parts, k) == \
                    jshard.shard_range(n, parts, k)
                keys = list(range(n))
                assert tshard.shard_keys(keys, parts, k) == \
                    jshard.shard_keys(keys, parts, k)
                assert tshard.assigned_batches(n, parts, k) == \
                    jshard.assigned_batches(n, parts, k)
            for nxt in (0, 1, n // 2, n, n + 3):
                assert tshard.reshard_batch_cursors(n, nxt, parts) == \
                    jshard.reshard_batch_cursors(n, nxt, parts)
    for bad in ((5, 0, 0), (5, 2, 2), (5, 2, -1)):
        with pytest.raises(ValueError):
            tshard.shard_range(*bad)
