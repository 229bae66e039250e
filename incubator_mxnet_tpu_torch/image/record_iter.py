"""ImageRecordIter: the production image pipeline (twin of
``incubator_mxnet_tpu/image/record_iter.py``; ref:
src/io/iter_image_recordio_2.cc ImageRecordIter2:660 — N decode
threads + augment + BatchLoader + double-buffered PrefetcherIter,
src/io/iter_prefetcher.h:47).

Same architecture, host-side: a thread pool decodes records in
parallel (PIL releases the GIL around codec work), a batcher
assembles NCHW arrays, and a one-slot-deep background prefetcher
overlaps the next batch's decode with the current device step —
the dmlc ThreadedIter double-buffer.  Batches are host (``cpu()``)
NDArrays; ``io.DevicePrefetchIter`` stages them on the card.

Draws are the JAX package's: the epoch shuffle from numpy's global
generator, crops and mirrors from ``random`` (PIL path) or numpy
(native path).  The pool decodes, and the producer augments each image
as its decode lands, in record order, so the draws come in record order
whatever ``preprocess_threads`` is: the batches are the same for every
thread count, and equal to the JAX package's bit for bit at
``preprocess_threads=1`` (its pool threads draw in a racing order).
``state_dict`` carries both generators' states as of the last delivered
batch (the producer reads ahead, so it records them batch by batch),
and a restore replays the stream exactly, random crops included.  A
``reset()`` of an epoch nothing was taken from keeps that epoch (the
JAX package reshuffles it, from generators its producer has moved): so
``fit``'s epoch-start reset of a fresh iterator trains the epoch a
plain iteration gives.  ``decoder_counts`` counts the batches each decoder (``"native"``,
``"pil"``) assembled, ``last_decoder`` names the last.
"""
import os
import queue
import random as pyrandom
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import recordio as rio
from ..io.io import (DataBatch, DataDesc, DataIter, _bounded_get,
                     _stop_aware_put)
from ..io.sharding import shard_keys
from .. import telemetry
from ..resilience import DataPipelineError, inject
from ..utils.env import get_env
from .image import CreateAugmenter, augment_to_chw, imdecode, nd_array

__all__ = ["ImageRecordIter"]


def _rng_state():
    """numpy's and ``random``'s global generator states."""
    return np.random.get_state(), pyrandom.getstate()


class ImageRecordIter(DataIter):
    """Reads .rec (+ optional .idx) shards (ref:
    iter_image_recordio_2.cc; python surface matches the reference's
    generated ImageRecordIter)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_width=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0, mean_g=0, mean_b=0,
                 std_r=0, std_g=0, std_b=0, resize=0,
                 preprocess_threads=4, prefetch_buffer=2,
                 data_name="data", label_name="softmax_label",
                 round_batch=True, num_parts=1, part_index=0,
                 aug_list=None, **kwargs):
        super().__init__(batch_size)
        if kwargs:
            warnings.warn(
                f"ImageRecordIter: ignoring unsupported options "
                f"{sorted(kwargs)}")
        self.round_batch = round_batch
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        mean = [mean_r, mean_g, mean_b] if (mean_r or mean_g or
                                            mean_b) else None
        std = [std_r, std_g, std_b] if (std_r or std_g or std_b) \
            else None
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(self.data_shape, resize=resize,
                            rand_crop=rand_crop,
                            rand_mirror=rand_mirror, mean=mean,
                            std=std)
        # native fast path (src/imgdec): decode+crop+mirror+normalize
        # in one C call with a persistent thread pool — the default
        # augmenter chain minus random crop.  PIL decode is GIL-bound
        # (~1k img/s flat regardless of threads); this is the
        # reference's decode-threads answer (iter_image_recordio_2).
        # Gated to the exactly-equivalent config: no custom augs, no
        # random crop, resize==0 (the native shorter-edge kernel is
        # not pixel-identical to PIL's antialiased resize), JPEG
        # records (checked per batch by magic bytes; non-JPEG batches
        # fall back to PIL transparently).
        self._native = None
        if (aug_list is None and not rand_crop and resize == 0
                and self.data_shape[0] == 3
                and os.environ.get("MXTPU_NATIVE_DECODE", "1") != "0"):
            from . import native_dec
            if native_dec.available():
                self._native = dict(
                    mirror_p=0.5 if rand_mirror else 0.0,
                    mean=np.asarray(mean, np.float32)
                    if mean is not None else None,
                    # CreateAugmenter only normalizes when mean is
                    # set; std alone must match that (no-op)
                    std=np.asarray(std, np.float32)
                    if std is not None and mean is not None else None,
                    nthreads=int(preprocess_threads))
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        # load the record offsets once; shuffle epoch-wise
        idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.exists(idx_path):
            self._rec = rio.MXIndexedRecordIO(idx_path, path_imgrec,
                                              "r")
            # contiguous record-boundary partition (exactly-once
            # coverage across parts; io/sharding.py — the floor
            # arithmetic keeps part edges exact for every N/P)
            self._keys = shard_keys(list(self._rec.keys), num_parts,
                                    part_index)
        else:
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            self._keys = None
            if num_parts != 1:
                raise ValueError("ImageRecordIter: sharded reads "
                                 f"(num_parts={num_parts}) need an "
                                 f".idx file beside {path_imgrec}")
        self._lock = threading.Lock()
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._prefetch_q = queue.Queue(maxsize=prefetch_buffer)
        self._producer = None
        self._stop = threading.Event()
        self._path = path_imgrec
        self._bad_records = 0       # cumulative corrupt-record count
        self._nbatch = 0            # batches delivered this epoch
        self._records_consumed = 0  # stream events through last
                                    # delivered batch (quarantines
                                    # consume extra records, so this
                                    # is NOT nbatch * batch_size)
        self._skip_batches = 0      # replay-discard count (skip())
        self._resume_pending = False
        self._resume_nbatch = 0
        self._resume_consumed = 0
        self._resume_skip = 0
        self.decoder_counts = {"native": 0, "pil": 0}
        self.last_decoder = None
        self.reset()

    # ------------------------------------------------------------ epoch
    def reset(self):
        if (not self._resume_pending and self._producer is not None
                and self._nbatch == 0 and self._skip_batches == 0):
            # an epoch nothing was taken from is kept: fit's epoch-start
            # reset of a fresh iterator must not reshuffle from a
            # generator state that the producer's read-ahead moved
            return
        self._drain()
        if self._resume_pending:
            # a just-restored position survives the train loop's
            # epoch-start reset (one-shot): keys order came from the
            # state_dict, so no reshuffle, and the producer restarts
            # the stream at the recorded consumption point
            self._resume_pending = False
            self._nbatch = self._resume_nbatch
            self._records_consumed = self._resume_consumed
            self._skip_batches = self._resume_skip
            self._resume_skip = 0
        else:
            if self._keys is not None and self.shuffle:
                np.random.shuffle(self._keys)
            self._nbatch = 0
            self._records_consumed = 0
            self._skip_batches = 0
        self._rng_state = _rng_state()
        if self._keys is None:
            self._rec.reset()
        self._stop.clear()
        self._producer = threading.Thread(target=self._produce,
                                          daemon=True)
        self._producer.start()

    def state_dict(self):
        """Position snapshot: delivered-batch count + the exact
        stream-consumption count through the last delivered batch
        (quarantined records consume extra stream events, so this is
        not derivable from nbatch) + epoch key order + cumulative
        bad-record count + numpy's and ``random``'s states after the
        last delivered batch's draws.  The producer thread reads ahead
        of next(), so delivered-batch accounting — not the reader
        cursor — is the resume point."""
        if self._resume_pending:
            nbatch, consumed, skip = (self._resume_nbatch,
                                      self._resume_consumed,
                                      self._resume_skip)
        else:
            nbatch, consumed, skip = (self._nbatch,
                                      self._records_consumed,
                                      self._skip_batches)
        return {"type": "ImageRecordIter",
                "nbatch": nbatch,
                "consumed": consumed,
                "skip": skip,
                "keys": list(self._keys)
                if self._keys is not None else None,
                "bad_records": self._bad_records,
                "np_rng": self._rng_state[0],
                "py_rng": self._rng_state[1]}

    def load_state_dict(self, state):
        if state.get("type") != "ImageRecordIter":
            raise ValueError(
                f"state_dict type {state.get('type')!r} does not "
                "match ImageRecordIter")
        keys = state.get("keys")
        if (keys is None) != (self._keys is None):
            raise ValueError(
                "iterator state and this ImageRecordIter disagree "
                "about having an .idx file — state from a different "
                "dataset?")
        self._drain()
        if keys is not None:
            self._keys = list(keys)
        self._bad_records = int(state.get("bad_records", 0))
        if state.get("np_rng") is not None:
            np.random.set_state(state["np_rng"])
        if state.get("py_rng") is not None:
            pyrandom.setstate(state["py_rng"])
        self._rng_state = _rng_state()
        self._resume_nbatch = int(state["nbatch"])
        self._resume_consumed = int(state["consumed"])
        self._resume_skip = int(state.get("skip", 0))
        self._resume_pending = True

    def skip(self, num_batches):
        """Fast-forward ``num_batches``: the producer replays them as
        discards from the recorded consumption point — assembling
        (and decoding) but not delivering — which stays exact even
        when quarantined records shifted per-batch consumption."""
        if self._resume_pending:
            base, consumed, skip = (self._resume_nbatch,
                                    self._resume_consumed,
                                    self._resume_skip)
        else:
            base, consumed, skip = (self._nbatch,
                                    self._records_consumed,
                                    self._skip_batches)
        self._resume_nbatch = base + num_batches
        self._resume_consumed = consumed
        self._resume_skip = skip + num_batches
        self._resume_pending = True
        self.reset()

    def _drain(self):
        """Stop the producer and empty the queue race-free: the
        producer's stop-aware put() exits on _stop, we JOIN it, and
        only then drain — so no stale item can land after the drain
        (the mid-epoch-reset hazard of a naive drain-then-join)."""
        if self._producer is not None:
            self._stop.set()
            while self._producer.is_alive():
                try:  # unblock a producer waiting in put()
                    self._prefetch_q.get_nowait()
                except queue.Empty:
                    pass
                self._producer.join(timeout=0.05)
            self._producer = None
        try:
            while True:
                self._prefetch_q.get_nowait()
        except queue.Empty:
            pass

    # ------------------------------------------------------------ workers
    def _read_raw(self, i):
        with self._lock:
            if self._keys is not None:
                return self._rec.read_idx(self._keys[i])
            return self._rec.read()

    def _decode_unpacked(self, pair):
        header, img_bytes = pair
        arr = augment_to_chw(imdecode(img_bytes), self.auglist)
        label = np.atleast_1d(np.asarray(header.label, np.float32))
        return arr, label

    @staticmethod
    def _safe_decode(pair):
        """(image, label) on success, (None, exc) on a decode failure —
        run in the pool, where a raise would be per-future noise; the
        producer turns failures into quarantine decisions."""
        header, img_bytes = pair
        try:
            img = imdecode(img_bytes)
        except Exception as exc:
            return None, exc
        return img, np.atleast_1d(np.asarray(header.label, np.float32))

    def _quarantine(self, exc, where):
        """Count one corrupt record against MXTPU_MAX_BAD_RECORDS:
        skip-and-log within the budget, raise past it."""
        self._bad_records += 1
        telemetry.counter("data_quarantined_records_total").inc()
        budget = get_env("MXTPU_MAX_BAD_RECORDS")
        if self._bad_records > budget:
            raise DataPipelineError(
                f"ImageRecordIter: {self._bad_records} corrupt "
                f"record(s) in {self._path} exceed "
                f"MXTPU_MAX_BAD_RECORDS={budget} (last failure at "
                f"{where}: {exc}); raise the budget to tolerate "
                "more, or repair the dataset") from exc
        warnings.warn(
            f"ImageRecordIter: skipping corrupt record in "
            f"{self._path} ({where}: {exc}); bad-record budget "
            f"{self._bad_records}/{budget}", RuntimeWarning)

    def _put(self, item):
        """Stop-aware put so a blocked producer can exit on reset."""
        return _stop_aware_put(self._prefetch_q, self._stop, item)

    def _records(self, consumed):
        """Generator of unpacked (header, img_bytes) pairs starting
        at stream event ``consumed["n"]``, quarantining corrupt
        reads/unpacks: the sequential backend resyncs the stream to
        the next magic, the keyed backend skips the bad key.

        ``consumed["n"]`` counts *stream events* — yielded records,
        unpack failures, and bad reads (one event per skipped key /
        resynced region) — so it is the exact resume coordinate even
        when quarantine consumed extra records per batch (keyed path:
        it equals the key index)."""
        n = len(self._keys) if self._keys is not None else None
        while True:
            i = consumed["n"]
            if n is not None and i >= n:
                return
            try:
                raw = self._read_raw(i)
            except IOError as exc:
                consumed["n"] += 1
                self._quarantine(exc, "read")
                if n is None:
                    with self._lock:
                        if self._rec.resync() is None:
                            return      # no further record magic
                continue
            if raw is None:
                return
            consumed["n"] += 1
            try:
                pair = rio.unpack(raw)
            except Exception as exc:
                self._quarantine(exc, "unpack")
                continue
            yield pair

    def _spool_sequential(self, num_events):
        """Sequential (no-.idx) resume: spool past ``num_events``
        already-consumed stream events without decoding, using the
        same event accounting as :meth:`_records` (a bad read +
        resync is one event) and without re-counting quarantines the
        pre-checkpoint run already charged to the budget."""
        left = num_events
        while left > 0 and not self._stop.is_set():
            try:
                if self._rec.read() is None:
                    return
            except IOError:
                with self._lock:
                    if self._rec.resync() is None:
                        return
            left -= 1

    def _produce(self):
        try:
            n = len(self._keys) if self._keys is not None else None
            consumed = {"n": self._records_consumed}
            skip = self._skip_batches
            if n is None and consumed["n"]:
                self._spool_sequential(consumed["n"])
            rec_gen = self._records(consumed)
            while not self._stop.is_set():
                inject("data", "record_batch")
                pairs = []
                while len(pairs) < self.batch_size:
                    pair = next(rec_gen, None)
                    if pair is None:
                        break
                    pairs.append(pair)
                if not pairs:
                    break
                pad = self.batch_size - len(pairs)
                c, h, w = self.data_shape
                data = np.zeros((self.batch_size, c, h, w),
                                np.float32)
                label = np.zeros((self.batch_size, self.label_width),
                                 np.float32)
                filled = 0
                done = False
                # libjpeg-only: non-JPEG batches (PNG/BMP) or jpegs
                # libjpeg rejects but PIL handles (CMYK) fall back to
                # the PIL path on the SAME unpacked records — never
                # abort what PIL could decode
                if self._native is not None and \
                        all(ib[:2] == b"\xff\xd8" for _, ib in pairs):
                    from . import native_dec
                    cfg = self._native
                    imgs = [ib for _, ib in pairs]
                    mirror = None
                    if cfg["mirror_p"] > 0:
                        mirror = (np.random.rand(len(imgs))
                                  < cfg["mirror_p"])
                    try:
                        native_dec.decode_batch(
                            imgs, (h, w), mirror=mirror,
                            mean=cfg["mean"], std=cfg["std"],
                            nthreads=cfg["nthreads"],
                            out=data[:len(imgs)])
                        done = True
                    except ValueError:
                        pass    # PIL fallback below decides
                decoder = "native" if done else "pil"
                if done:
                    for j, (header, _) in enumerate(pairs):
                        lab = np.atleast_1d(np.asarray(
                            header.label, np.float32))
                        label[j] = lab[:self.label_width]
                    filled = len(pairs)
                else:
                    # PIL path with per-record quarantine: decode
                    # failures are skipped and replaced from the
                    # stream so mid-epoch batches stay full
                    # (the pool decodes; each image is augmented here,
                    # in record order, as its decode lands)
                    pending = pairs
                    while pending:
                        lost = 0
                        for img, payload in self._pool.map(
                                self._safe_decode, pending):
                            if img is None:
                                self._quarantine(payload, "decode")
                                lost += 1
                                continue
                            try:
                                arr = augment_to_chw(img, self.auglist)
                            except Exception as exc:
                                self._quarantine(exc, "augment")
                                lost += 1
                                continue
                            if filled < self.batch_size:
                                data[filled] = arr
                                label[filled] = \
                                    payload[:self.label_width]
                                filled += 1
                        if not lost:
                            break
                        pending = []
                        while len(pending) < lost:
                            pair = next(rec_gen, None)
                            if pair is None:
                                break
                            pending.append(pair)
                    pad = self.batch_size - filled
                if pad > 0 and self.round_batch and n is not None:
                    # wrap the tail with epoch-start samples (ref:
                    # round_batch semantics of the C++ iterator);
                    # wrap filler is stripped by pad-aware consumers,
                    # so a corrupt wrap record is simply skipped
                    j = 0
                    while filled < self.batch_size and j < 2 * n:
                        try:
                            arr, lab = self._decode_unpacked(
                                rio.unpack(self._read_raw(j % n)))
                        except Exception:
                            j += 1
                            continue
                        data[filled] = arr
                        label[filled] = lab[:self.label_width]
                        filled += 1
                        j += 1
                if skip > 0:
                    # replay-discard (skip()): the batch was
                    # assembled so consumption advanced exactly as in
                    # the original run, but it was already delivered
                    # pre-checkpoint — drop it
                    skip -= 1
                    if pad > 0:
                        break
                    continue
                if not self._put((data, label, pad, consumed["n"],
                                  decoder, _rng_state())):
                    return  # reset() interrupted us; no sentinel
                if pad > 0:
                    break
            self._put(None)  # epoch sentinel
        except Exception as e:  # surface errors in the consumer
            self._put(("error", e))

    # ------------------------------------------------------------ iter
    def next(self):
        if self._resume_pending:
            self.reset()    # applies the restored position
        if self._producer is None:
            raise StopIteration  # epoch ended; call reset()
        item = _bounded_get(self._prefetch_q,
                            f"ImageRecordIter({self._path})",
                            thread=self._producer)
        if item is None:
            self._producer.join(timeout=5)
            self._producer = None
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] == "error":
            self._producer = None
            exc = item[1]
            if isinstance(exc, DataPipelineError):
                raise exc
            err = DataPipelineError(
                f"ImageRecordIter({self._path}) producer raised "
                f"{type(exc).__name__}: {exc}")
            err.__cause__ = exc
            raise err
        data, label, pad, consumed, decoder, self._rng_state = item
        self._nbatch += 1
        telemetry.counter("prefetch_batches_total").inc()
        self.decoder_counts[decoder] += 1
        self.last_decoder = decoder
        self._records_consumed = consumed
        self._skip_batches = 0   # any replay-discard phase is over
        label_out = label[:, 0] if self.label_width == 1 else label
        return DataBatch([nd_array(data)], [nd_array(label_out)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __del__(self):
        try:
            self._drain()
            self._pool.shutdown(wait=False)
        except Exception:
            pass
