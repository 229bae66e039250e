"""Decode worker process for the sharded data service (twin of
``incubator_mxnet_tpu/data_service/worker.py``; docs/data_service.md).

Each worker owns the global batch indices ``shard, shard+W, ...`` of
the epoch's key order (io.sharding.assigned_batches), opens its OWN
RecordIO reader, decodes with the native ``src/imgdec`` fast path
(its own C thread pool — decode scales with processes instead of
hitting the single-process/GIL ceiling) with per-record PIL-fallback
quarantine, and writes finished batches *directly into* its shard's
shared-memory ring slots (the native decoder's ``out=`` points at
the slot, so a batch crosses the process boundary with one
consumer-side memcpy total).

Workers are **persistent**: spawned once per service (fork), they
prefault their ring pages and then loop on a control pipe — one
command per epoch carries the key order and resume cursors.  Epoch
turnover therefore costs one control-pipe pickle per worker (O(N) in
the key order, but far below the respawn + page-table refault it
replaces — measured at hundreds of ms per worker on this host's
kernel).  Only death (SIGKILL/OOM — supervised by the parent) or a
mid-epoch abandon forces a respawn.

The decode pipeline is deliberately the same shape as
``ImageRecordIter._produce`` (native whole-batch attempt gated to
JPEG magic, PIL per-record quarantine with stream top-up, round_batch
wrap padding on the last global batch), so deterministic-mode batches
are bit-identical to the single-process iterator — the service's
correctness contract, pinned by tests/test_data_service.py.

Workers are numpy-only (plus ctypes into the native decoder, else
PIL): the decode path runs the image module's numpy cores
(``_imdecode_np``, ``augment_to_chw``), builds no NDArray and never
touches ``torch.cuda``, so forking from a parent that has initialized
CUDA is safe.  The locks of the telemetry, tracing, resilience and
debugz modules are re-created in the child (``os.register_at_fork``),
so a worker forked while another parent thread held one never waits
on it.  The
native decoder's thread pool re-arms itself after fork
(src/imgdec pthread_atfork handler), so each worker gets real decode
threads even when the parent used the pool before spawning.
"""
import os
import random as _pyrandom
import warnings

import numpy as np

from .. import recordio as rio
from ..image import native_dec
from ..image.image import CreateAugmenter, augment_to_chw
from ..image.image import _imdecode_np as imdecode
from ..io.sharding import assigned_batches
from ..resilience import inject

__all__ = ["worker_main", "build_decode_spec"]


def build_decode_spec(data_shape, resize=0, rand_crop=False,
                      rand_mirror=False, mean=None, std=None,
                      preprocess_threads=1):
    """Decode configuration shipped to workers; mirrors the
    ImageRecordIter native-path gate (no random crop, resize==0,
    3-channel, MXTPU_NATIVE_DECODE not disabled)."""
    native = (not rand_crop and resize == 0 and data_shape[0] == 3
              and os.environ.get("MXTPU_NATIVE_DECODE", "1") != "0"
              and native_dec.available())
    return {
        "data_shape": tuple(data_shape),
        "resize": int(resize),
        "rand_crop": bool(rand_crop),
        "rand_mirror": bool(rand_mirror),
        "mean": None if mean is None else [float(v) for v in mean],
        "std": None if std is None else [float(v) for v in std],
        "nthreads": int(preprocess_threads),
        "native": bool(native),
    }


class _ShardStream:
    """Ordered (header, img_bytes) stream over the shard's assigned
    key sequence with event-counted quarantine: every attempted key
    is ONE stream event (yielded record, bad read, or bad unpack), so
    the event cursor is the exact resume coordinate — the
    ImageRecordIter._records accounting, per shard."""

    def __init__(self, rec, keys_seq, start_event, start_bad):
        self._rec = rec
        self._keys = keys_seq
        self.event = start_event
        self.bad = start_bad

    def quarantine(self, exc, where, key):
        self.bad += 1
        warnings.warn(
            f"data-service worker: skipping corrupt record "
            f"key={key} ({where}: {exc}); shard bad-record count "
            f"{self.bad} (budget is enforced globally by the "
            "consumer under MXTPU_MAX_BAD_RECORDS)", RuntimeWarning)

    def next_pair(self):
        """Next good (header, img_bytes), or None at exhaustion."""
        while self.event < len(self._keys):
            key = self._keys[self.event]
            self.event += 1
            try:
                raw = self._rec.read_idx(key)
            except IOError as exc:
                self.quarantine(exc, "read", key)
                continue
            try:
                return rio.unpack(raw)
            except Exception as exc:
                self.quarantine(exc, "unpack", key)
                continue
        return None


def _set_label(label, row, header, label_width):
    lab = np.atleast_1d(np.asarray(header.label, np.float32))
    label[row] = lab[:label_width]


def _try_native(pairs, spec, rng, data, label, label_width):
    """Whole-batch native decode straight into the slot when every
    record is a JPEG; False falls through to the PIL path on the
    SAME unpacked records (the ImageRecordIter gate, including the
    std-without-mean no-op)."""
    if not (spec["native"] and pairs
            and all(ib[:2] == b"\xff\xd8" for _, ib in pairs)):
        return False
    imgs = [ib for _, ib in pairs]
    mirror = None
    if spec["rand_mirror"]:
        mirror = rng.rand(len(imgs)) < 0.5
    mean = None if spec["mean"] is None else \
        np.asarray(spec["mean"], np.float32)
    std = None if (spec["std"] is None or spec["mean"] is None) \
        else np.asarray(spec["std"], np.float32)
    try:
        native_dec.decode_batch(
            imgs, (spec["data_shape"][1], spec["data_shape"][2]),
            mirror=mirror, mean=mean, std=std,
            nthreads=spec["nthreads"], out=data[:len(imgs)])
    except ValueError:
        return False
    for j, (header, _) in enumerate(pairs):
        _set_label(label, j, header, label_width)
    return True


def _die_with_parent():
    """Arm the Linux parent-death signal: a rank hard-killed by the
    elastic supervisor (SIGKILL / injected ``elastic:rank`` kill —
    no teardown, no atexit, so multiprocessing's daemon cleanup
    never runs) must not orphan its decode workers.  Orphans would
    survive holding their /dev/shm ring segments and the parent's
    inherited pipes open — leaking shared memory and wedging any
    launcher/pytest reader waiting for pipe EOF.  With PDEATHSIG the
    kernel reaps the whole decode fleet the instant the rank dies.
    Best-effort: off Linux this is a no-op and close() remains the
    only cleanup path (docs/elastic.md failure matrix)."""
    try:
        import ctypes
        import signal
        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except Exception:
        return
    if os.getppid() == 1:
        # parent already died in the fork->prctl window: the signal
        # will never arrive, exit now instead of idling forever
        os._exit(0)


def worker_main(ring, conn, static_spec):
    """Child-process entry: prefault the ring pages, then serve one
    epoch per control-pipe command until the pipe closes.  An epoch
    ends with an END slot; any raise ships as an ERROR slot and the
    worker survives to take the next command."""
    _die_with_parent()
    ring.prefault()
    while True:
        try:
            cmd = conn.recv()
        except (EOFError, OSError):
            return
        if cmd is None:
            return
        try:
            _run_shard(ring, {**static_spec, **cmd})
        except Exception as exc:      # surface in the consumer, typed
            try:
                ring.put_error(exc)
            except Exception:
                pass


def _run_shard(ring, spec):
    rec = rio.MXIndexedRecordIO(spec["idx_path"],
                                spec["path_imgrec"], "r")
    try:
        _serve_epoch(ring, rec, spec)
    finally:
        # the worker is persistent: an epoch that raises must not
        # leak its fd (the raise ships as an ERROR slot and the
        # process lives on to take the next command)
        rec.close()


def _serve_epoch(ring, rec, spec):
    B = spec["batch_size"]
    order = spec["order"]
    n = len(order)
    label_width = spec["label_width"]
    dec = spec["decode"]
    my_batches = assigned_batches(spec["num_batches"],
                                  spec["num_shards"], spec["shard"])
    # flattened assigned key sequence: the shard's private stream
    # (quarantine top-ups consume records that would have fed this
    # shard's LATER batches, never another shard's)
    keys_seq = []
    for b in my_batches:
        keys_seq.extend(order[b * B:min((b + 1) * B, n)])
    stream = _ShardStream(rec, keys_seq, spec["start_event"],
                          spec["start_bad"])
    auglist = CreateAugmenter(
        dec["data_shape"], resize=dec["resize"],
        rand_crop=dec["rand_crop"], rand_mirror=dec["rand_mirror"],
        mean=dec["mean"], std=dec["std"])
    for k in range(spec["start_batch"], len(my_batches)):
        inject("data_service", "worker")
        # random draws are keyed to the GLOBAL batch index, not a
        # per-epoch stream: a respawned/resumed worker starting at
        # batch k reproduces exactly the draws the original made
        # (batch indices are globally unique across shards).  The
        # stdlib seed covers the PIL-fallback augmenters
        # (image.Augmenter uses `random`), the RandomState the
        # native mirror vector — both paths stay bit-exact across
        # the process frontier.
        seed_k = (spec["seed"] + my_batches[k]) % (1 << 32)
        rng = np.random.RandomState(seed_k)
        _pyrandom.seed(seed_k)
        pairs = []
        while len(pairs) < B:
            pair = stream.next_pair()
            if pair is None:
                break
            pairs.append(pair)
        if not pairs:
            break
        slot = ring.produce_slot()   # backpressure BEFORE decode
        if slot is None:
            return        # teardown interrupted us; no sentinel
        data, label = slot
        if _try_native(pairs, dec, rng, data, label, label_width):
            filled = len(pairs)
        else:
            # PIL path with per-record quarantine: failures are
            # skipped and replaced from the shard stream so
            # mid-epoch batches stay full
            filled = 0
            pending = pairs
            while pending:
                lost = 0
                for header, img_bytes in pending:
                    try:
                        arr = augment_to_chw(imdecode(img_bytes),
                                             auglist)
                    except Exception as exc:
                        stream.quarantine(exc, "decode", "?")
                        lost += 1
                        continue
                    if filled < B:
                        data[filled] = arr
                        _set_label(label, filled, header,
                                   label_width)
                        filled += 1
                if not lost:
                    break
                pending = []
                while len(pending) < lost:
                    pair = stream.next_pair()
                    if pair is None:
                        break
                    pending.append(pair)
        pad = B - filled
        if pad > 0 and spec["round_batch"]:
            # wrap the tail with epoch-start samples (single-process
            # round_batch semantics: the reported pad stays the
            # pre-wrap shortfall — wrap filler is data for shape
            # consistency, stripped by pad-aware consumers); corrupt
            # wrap records are simply skipped
            j = 0
            while filled < B and j < 2 * n:
                try:
                    header, img_bytes = rio.unpack(
                        rec.read_idx(order[j % n]))
                    arr = augment_to_chw(imdecode(img_bytes), auglist)
                except Exception:
                    j += 1
                    continue
                data[filled] = arr
                _set_label(label, filled, header, label_width)
                filled += 1
                j += 1
        if filled < B:
            # zero the tail rows in place (slots are reused, and the
            # single-process iterator zero-fills its batch buffers)
            data[filled:] = 0.0
            label[filled:] = 0.0
        ring.commit(filled, pad, stream.event, stream.bad,
                    my_batches[k])
        if pad > 0:
            break         # shard exhausted mid-batch
    ring.put_end(stream.event, stream.bad)
