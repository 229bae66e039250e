"""`DataServiceIter`: sharded multi-process input data service (twin
of ``incubator_mxnet_tpu/data_service/service.py``;
docs/data_service.md).

One process decoding and augmenting beside the training loop shares
its interpreter with that loop.  This service shards the epoch across
N decode worker *processes* and streams finished batches back through
bounded shared-memory rings, so aggregate decode throughput scales
with cores.  Batches are host (``cpu()``) NDArrays, as
``ImageRecordIter``'s are; ``io.DevicePrefetchIter`` stages them on
the card.

Contracts:

- **DataIter protocol** — ``fit()``, ``DevicePrefetchIter`` and the
  checkpoint ``.data`` companions consume it unchanged
  (``provide_data``/``provide_label``/``next``/``reset``/
  ``state_dict``/``load_state_dict``/``skip``).
- **Determinism** — worker ``w`` owns global batch indices
  ``w, w+W, ...`` of the epoch key order and the parent merges
  round-robin, so with a fixed order and no random augmentation the
  delivered stream is bit-identical to the single-process
  ``ImageRecordIter`` (pinned by tests).
- **Resume** — per-shard stream-event cursors + the merge position
  serialize into ``state_dict()`` (and therefore into the ``.data``
  checkpoint companions); restore respawns every live shard at its
  exact cursor, so a mid-epoch resume lands on the exact next batch.
  A state saved with W workers restores under W′ ≠ W (elastic
  restart changed the data-worker count): the merged stream's
  position is one global batch index, and the per-shard cursors are
  re-derived round-robin (``io.sharding.reshard_batch_cursors``) —
  bit-consistent with the uninterrupted stream, except that with
  quarantined corrupt records the resume replays the W′ stream to
  the same global batch instead (docs/elastic.md).
- **Supervision** — a worker observed dead (SIGKILL, OOM) is
  respawned from its last-delivered cursor under the
  ``MXTPU_DATA_WORKER_RESTARTS`` budget with flight-recorder events
  (`data_service_worker_dead`/`data_service_worker_restart`); every
  shard's corrupt-record quarantine rolls up into the ONE global
  ``MXTPU_MAX_BAD_RECORDS`` budget.
- **Remote ranks** — ``remote_addrs`` / ``MXTPU_DATA_REMOTE_ADDRS``
  re-homes the LAST ``len(addrs)`` shards onto remote decode hosts
  (``data_service/net.py``): same worker code, same epoch commands,
  batches stream back as CRC-framed RPC frames instead of shm slots,
  and the round-robin merge cannot tell the transports apart — the
  delivered stream stays bit-identical to all-local.  A poisoned
  link or dead host re-homes its shard (reconnect, else a local
  respawn at the same cursors) under the same restart budget
  (docs/data_service.md "Remote ranks").

Workers are persistent (one fork per shard for the service lifetime):
a clean epoch boundary is one small command down each control pipe —
no respawn, no ring reallocation, no page refaulting.  Only a
mid-epoch abandon (reset before exhaustion, resume restore) or a
death tears a worker down.
"""
import multiprocessing as _mp
import os
import time
import warnings

import numpy as np

from .. import telemetry
from ..io.io import DataBatch, DataDesc, DataIter
from ..io.sharding import reshard_batch_cursors
from ..image.image import nd_array
from ..resilience import DataPipelineError, data_timeout, inject
from ..tracing import trace_event
from ..utils.env import get_env
from . import net as _net
from . import ring as _ring
from .worker import build_decode_spec, worker_main

__all__ = ["DataServiceIter"]


class DataServiceIter(DataIter):
    """Multi-process RecordIO image iterator (see module docstring).

    Arguments mirror ``ImageRecordIter`` where they overlap; the
    service-specific knobs are ``num_workers`` (decode processes;
    default ``MXTPU_DATA_WORKERS``) and ``ring_depth`` (per-shard
    staged batches; default ``MXTPU_DATA_RING_DEPTH``).
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 num_workers=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0,
                 mean_g=0, mean_b=0, std_r=0, std_g=0, std_b=0,
                 resize=0, preprocess_threads=1, ring_depth=None,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", remote_addrs=None):
        super().__init__(batch_size)
        self._W = int(num_workers if num_workers is not None
                      else get_env("MXTPU_DATA_WORKERS"))
        if self._W < 1:
            self._W = 1
        depth = int(ring_depth if ring_depth is not None
                    else get_env("MXTPU_DATA_RING_DEPTH"))
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.shuffle = shuffle
        self.round_batch = round_batch
        self._path = path_imgrec
        idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise ValueError(
                f"DataServiceIter needs {idx_path}: the service "
                "shards by record index (build one with "
                "tools/rec2idx.py)")
        self._idx_path = idx_path
        mean = [mean_r, mean_g, mean_b] if (mean_r or mean_g or
                                            mean_b) else None
        std = [std_r, std_g, std_b] if (std_r or std_g or std_b) \
            else None
        self._decode = build_decode_spec(
            self.data_shape, resize=resize, rand_crop=rand_crop,
            rand_mirror=rand_mirror, mean=mean, std=std,
            preprocess_threads=preprocess_threads)
        self._rand_mirror = bool(rand_mirror)
        # key universe, read once (the workers reopen their own fds)
        from .. import recordio as rio
        rdr = rio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
        self._base_keys = list(rdr.keys)
        rdr.close()
        if not self._base_keys:
            raise ValueError(f"{idx_path} lists no records")
        self._order = list(self._base_keys)
        self._num_batches = (len(self._order) + batch_size - 1) \
            // batch_size
        self.provide_data = [DataDesc(
            data_name, (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._ctx = _mp.get_context("fork")
        # teardown state BEFORE the rings exist: if the Nth ring ctor
        # raises (e.g. /dev/shm exhausted), __del__ -> close() must
        # find a consistent object and unlink the N-1 live segments
        self._procs = [None] * self._W
        self._conns = [None] * self._W
        self._rings = []
        self._remotes = {}
        self._closed = False
        self._resume_pending = False
        self._resume_state = None
        self._restarts = 0
        self._bad_total = 0
        self._shard_bad = [0] * self._W
        self._shard_done = [True] * self._W   # "pre-epoch": clean
        self._depth = depth
        credits = int(get_env("MXTPU_DATA_NET_CREDITS"))
        self._net_credits = credits if credits > 0 else depth
        if remote_addrs is None:
            raw = get_env("MXTPU_DATA_REMOTE_ADDRS")
            remote_addrs = [a.strip() for a in raw.split(",")
                            if a.strip()] if raw else []
        addrs = list(remote_addrs)
        if len(addrs) > self._W:
            warnings.warn(
                f"DataServiceIter: {len(addrs)} remote addr(s) for "
                f"{self._W} shard(s); the last "
                f"{len(addrs) - self._W} go unused", RuntimeWarning)
            addrs = addrs[:self._W]
        # every shard still gets a LOCAL ring, even remote ones:
        # it is the failover demote target when a remote host dies
        # for good (shards re-home at their exact cursors)
        for w in range(self._W):
            self._rings.append(
                _ring.ShmBatchRing(batch_size, self.data_shape,
                                   self.label_width, depth, self._ctx,
                                   tag=f"_s{w}"))
        # placement: the LAST len(addrs) shards stream over sockets
        # (shard identity, cursors, and the merge order never depend
        # on placement — that is the bit-identity argument)
        first_remote = self._W - len(addrs)
        for i, addr in enumerate(addrs):
            w = first_remote + i
            self._remotes[w] = _net.RemoteShard(
                w, addr, batch_size, self.data_shape,
                self.label_width)
        self.reset()

    # ------------------------------------------------------------ epoch
    def _epoch_init(self):
        self._bidx = 0
        self._shard_consumed = [0] * self._W
        self._shard_delivered = [0] * self._W
        self._shard_done = [False] * self._W
        self._epoch_t0 = time.monotonic()
        self._epoch_imgs = 0
        self._shard_imgs = [0] * self._W

    def _epoch_cmd(self, w):
        """One epoch of work for shard ``w`` at its current cursors
        (zero for a fresh epoch; mid-epoch for restart/resume)."""
        return {
            "order": self._order,
            "num_batches": self._num_batches,
            "start_event": self._shard_consumed[w],
            "start_batch": self._shard_delivered[w],
            "start_bad": self._shard_bad[w],
            "seed": self._seed_base,
        }

    def reset(self):
        if self._resume_pending:
            # a just-restored position survives the train loop's
            # epoch-start reset (one-shot): the key order came from
            # the state_dict, and every live shard respawns at its
            # recorded cursor
            self._resume_pending = False
            st = self._resume_state
            self._resume_state = None
            self._halt_workers()
            self._order = list(st["order"])
            self._num_batches = (len(self._order) + self.batch_size
                                 - 1) // self.batch_size
            if st.get("np_rng") is not None:
                np.random.set_state(st["np_rng"])
            self._epoch_init()
            self._bidx = int(st["bidx"])
            self._shard_consumed = [int(v) for v in
                                    st["shard_consumed"]]
            self._shard_delivered = [int(v) for v in
                                     st["shard_delivered"]]
            self._shard_done = [bool(v) for v in st["shard_done"]]
            self._shard_bad = [int(v) for v in st["shard_bad"]]
            self._bad_total = int(st["bad_total"])
            # the mirror seed base is part of the position: redrawing
            # it would re-mirror the remaining batches AND burn a
            # global-RNG draw the uninterrupted run never made
            self._seed_base = int(st.get("seed_base", 0))
            for w in range(self._W):
                if not self._shard_done[w]:
                    self._start_shard(w)
            # a resharded-under-quarantine position resumes by exact
            # replay: deliver-and-discard to the recorded global
            # batch (ImageRecordIter's replay-discard semantics —
            # corrupt records re-quarantine deterministically)
            skip = int(st.get("pending_skip", 0))
            for _ in range(skip):
                self._consume_one()
            return
        clean = all(self._shard_done)
        if not clean:
            # mid-epoch abandon: the workers are mid-stream and the
            # rings hold undelivered slots — tear down and respawn
            # (the rare path; clean epoch turnover below is just a
            # command per pipe)
            self._halt_workers()
        if self.shuffle:
            np.random.shuffle(self._order)
        self._epoch_init()
        self._pick_seed_base()
        for w in range(self._W):
            self._start_shard(w)

    def _pick_seed_base(self):
        # mirror draws must not touch the global RNG stream unless
        # mirroring is on (shuffle determinism vs ImageRecordIter)
        self._seed_base = int(np.random.randint(1 << 31)) \
            if self._rand_mirror else 0

    def _static_spec(self, w):
        """The worker spec for shard ``w`` — identical whether the
        worker forks locally or runs on a remote host (the remote
        server adds nothing and removes nothing: that is half of the
        bit-identity argument; the other half is the epoch command's
        global-batch-keyed seeding)."""
        return {
            "path_imgrec": self._path,
            "idx_path": self._idx_path,
            "shard": w,
            "num_shards": self._W,
            "batch_size": self.batch_size,
            "label_width": self.label_width,
            "round_batch": self.round_batch,
            "decode": self._decode,
            "ring_depth": self._depth,
        }

    def _start_shard(self, w):
        """Start (or command) shard ``w``'s next epoch on whatever
        transport currently homes it."""
        rs = self._remotes.get(w)
        if rs is None:
            if self._procs[w] is not None \
                    and self._procs[w].is_alive():
                self._conns[w].send(self._epoch_cmd(w))
            else:
                self._spawn_shard(w)
            return
        try:
            rs.start_epoch(self._static_spec(w), self._epoch_cmd(w),
                           self._net_credits)
        except _net.RemoteShardDown as e:
            self._remote_failover(w, e)

    def _remote_failover(self, w, why):
        """Re-home remote shard ``w`` after its link poisoned or its
        host went silent: one budgeted attempt against the same host
        on a fresh connection, else demote to a local worker — either
        way the shard restarts at its exact last-delivered cursors,
        so the merged stream continues bit-identically."""
        rs = self._remotes[w]
        source = f"DataServiceIter({self._path}) shard {w}"
        trace_event("data_service_host_down", shard=w, addr=rs.addr,
                    why=str(why),
                    delivered=self._shard_delivered[w],
                    consumed=self._shard_consumed[w])
        budget = get_env("MXTPU_DATA_WORKER_RESTARTS")
        if self._restarts >= budget:
            raise DataPipelineError(
                f"{source}: remote host {rs.addr} down ({why}) and "
                f"the restart budget is spent (restarted "
                f"{self._restarts} time(s), "
                f"MXTPU_DATA_WORKER_RESTARTS={budget}); check the "
                "remote host and MXTPU_DATA_REMOTE_ADDRS") from None
        self._restarts += 1
        telemetry.counter("data_service_net_restarts_total").inc()
        if rs.try_restart(self._static_spec(w), self._epoch_cmd(w),
                          self._net_credits):
            trace_event("data_service_failover", shard=w,
                        target="remote", addr=rs.addr,
                        restart=self._restarts, budget=budget)
            warnings.warn(
                f"{source}: link to {rs.addr} poisoned ({why}); "
                f"reconnected and resumed from batch "
                f"{self._shard_delivered[w]} (restart "
                f"{self._restarts}/{budget})", RuntimeWarning)
            return
        # the host is really gone: re-home onto a local worker (its
        # ring was provisioned at construction for exactly this)
        rs.close()
        del self._remotes[w]
        trace_event("data_service_failover", shard=w,
                    target="local", addr=rs.addr,
                    restart=self._restarts, budget=budget)
        warnings.warn(
            f"{source}: remote host {rs.addr} is down ({why}); "
            f"re-homing the shard to a local worker from batch "
            f"{self._shard_delivered[w]} (restart "
            f"{self._restarts}/{budget})", RuntimeWarning)
        self._spawn_shard(w)

    def _spawn_shard(self, w):
        """(Re)spawn shard ``w``'s local worker and hand it the
        current epoch command at the shard's current cursors."""
        if self._procs[w] is not None:
            self._reap_shard(w)
        static_spec = self._static_spec(w)
        self._rings[w].reset_sync()
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=worker_main,
            args=(self._rings[w], child_conn, static_spec),
            daemon=True, name=f"mxtpu-data-service-{w}")
        proc.start()
        child_conn.close()
        self._procs[w] = proc
        self._conns[w] = parent_conn
        parent_conn.send(self._epoch_cmd(w))

    def _reap_shard(self, w):
        proc = self._procs[w]
        if proc is None:
            return
        self._rings[w].request_stop()
        try:
            self._conns[w].send(None)   # unblock a recv-idle worker
        except (OSError, ValueError, BrokenPipeError):
            pass
        proc.join(timeout=2)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
        try:
            self._conns[w].close()
        except Exception:
            pass
        self._procs[w] = None
        self._conns[w] = None

    def _halt_workers(self):
        for w in range(self._W):
            self._reap_shard(w)
        for rs in self._remotes.values():
            rs.stop_stream()

    # ------------------------------------------------- resumable state
    def state_dict(self):
        """Exact multi-process position: epoch key order + global
        merge slot + per-shard stream-event cursors / delivered
        counts / quarantine counts + the numpy RNG state (shuffle
        source) — everything a fresh service needs to respawn every
        shard at the exact next batch."""
        if self._resume_pending:
            return dict(self._resume_state)
        return {"type": "DataServiceIter",
                "num_shards": self._W,
                "order": list(self._order),
                "bidx": self._bidx,
                "shard_consumed": list(self._shard_consumed),
                "shard_delivered": list(self._shard_delivered),
                "shard_done": list(self._shard_done),
                "shard_bad": list(self._shard_bad),
                "bad_total": self._bad_total,
                "seed_base": self._seed_base,
                "np_rng": np.random.get_state()}

    def load_state_dict(self, state):
        if state.get("type") != "DataServiceIter":
            raise ValueError(
                f"state_dict type {state.get('type')!r} does not "
                "match DataServiceIter")
        order = state.get("order") or []
        if sorted(order) != sorted(self._base_keys):
            # the one genuinely un-reshardable mismatch: cursors
            # into a different dataset mean nothing here
            raise ValueError(
                "iterator state's key set does not match this "
                "dataset's .idx — state from a different dataset?")
        if int(state.get("num_shards", -1)) != self._W:
            state = self._reshard_state(state)
        self._halt_workers()
        self._shard_done = [True] * self._W   # nothing in flight
        self._resume_state = dict(state)
        self._resume_pending = True

    def _reshard_state(self, state):
        """Re-express a position saved with W workers for this
        service's W′ (elastic restart changed the data-worker count,
        docs/elastic.md).  The merged stream's position is the next
        *global* batch — round-robin re-derivation of the per-shard
        cursors (io.sharding.reshard_batch_cursors) resumes it
        bit-consistently: worker random draws are keyed to global
        batch indices, so the remaining stream is identical to an
        uninterrupted run's.

        Quarantined corrupt records entangle the saved key cursors
        with the OLD shards' top-up reads, so when any were recorded
        the resume replays from the epoch start instead
        (deliver-and-discard to the same global batch — exact, since
        corruption re-quarantines deterministically; the quarantine
        ledger re-counts from zero during the replay)."""
        W_old = int(state.get("num_shards", -1))
        Wn = self._W
        order = list(state["order"])
        n = len(order)
        B = self.batch_size
        nb = (n + B - 1) // B
        # a state saved while a quarantine-replay resume was still
        # pending holds its position in pending_skip (cursors are
        # zeroed): carry it forward, and stay in replay mode — the
        # entanglement reason (corrupt records) has not gone away
        # even though its bad_total ledger was reset
        pend = int(state.get("pending_skip", 0))
        replay = int(state.get("bad_total", 0)) > 0 or pend > 0
        delivered_total = sum(int(v)
                              for v in state["shard_delivered"]) \
            + pend
        g = delivered_total if replay \
            else min(int(state["bidx"]), nb)
        trace_event("data_cursor_reshard", from_shards=W_old,
                    to_shards=Wn, next_batch=g, replay=replay)
        new = dict(state)
        new["num_shards"] = Wn
        new["shard_bad"] = [0] * Wn
        new["bad_total"] = 0
        new.pop("pending_skip", None)
        if replay:
            warnings.warn(
                f"DataServiceIter: resharding {W_old} -> {Wn} "
                f"worker cursor(s) saved under quarantine: resuming "
                f"by exact replay of {g} batch(es) from the epoch "
                "start (corrupt records re-quarantine against a "
                "fresh MXTPU_MAX_BAD_RECORDS budget)",
                RuntimeWarning)
            new.update(bidx=0, shard_consumed=[0] * Wn,
                       shard_delivered=[0] * Wn,
                       shard_done=[False] * Wn, pending_skip=g)
            return new
        delivered, done = reshard_batch_cursors(nb, g, Wn)
        # event cursors count attempted keys: with no quarantine on
        # record, every delivered batch consumed exactly B keys —
        # the only short batch is the last one (index nb-1), and
        # g <= nb-1 here (g == nb marks every shard done and no
        # worker respawns), so it is never part of the count
        consumed = [d * B for d in delivered]
        new.update(bidx=g, shard_consumed=consumed,
                   shard_delivered=delivered, shard_done=done)
        return new

    def skip(self, num_batches):
        """Fast-forward by delivering-and-discarding (exact under
        quarantine, mirroring ImageRecordIter's replay-discard)."""
        if self._resume_pending:
            self.reset()
        for _ in range(num_batches):
            self._consume_one()

    # ------------------------------------------------------------ merge
    def _rollup_bad(self, w, bad):
        """Fold one shard's cumulative quarantine count into the
        global budget; past it the whole stream fails typed."""
        delta = bad - self._shard_bad[w]
        if delta <= 0:
            return
        self._shard_bad[w] = bad
        self._bad_total += delta
        telemetry.counter("data_quarantined_records_total").inc(delta)
        budget = get_env("MXTPU_MAX_BAD_RECORDS")
        if self._bad_total > budget:
            raise DataPipelineError(
                f"DataServiceIter: {self._bad_total} corrupt "
                f"record(s) across {self._W} shard(s) of "
                f"{self._path} exceed MXTPU_MAX_BAD_RECORDS="
                f"{budget} (aggregated globally); raise the budget "
                "to tolerate more, or repair the dataset")

    def _get_from_shard(self, w):
        """One take with supervision: a dead local worker is
        respawned, a down remote host re-homed (same host on a fresh
        link, else a local worker) — always from the shard's
        last-delivered cursor, under the one restart budget."""
        inject("data_service", "ring")
        source = f"DataServiceIter({self._path}) shard {w}"
        while True:
            rs = self._remotes.get(w)
            if rs is not None:
                try:
                    return rs.get(source, data_timeout())
                except _net.RemoteShardDown as e:
                    # after failover the shard is either back on its
                    # remote (loop retries the socket) or demoted
                    # (loop falls through to the local ring)
                    self._remote_failover(w, e)
                    continue
            proc = self._procs[w]
            alive = proc.is_alive if proc is not None \
                else (lambda: False)
            try:
                return self._rings[w].get(source, alive,
                                          data_timeout())
            except _ring.RingProducerDead:
                exitcode = proc.exitcode if proc is not None else None
                trace_event("data_service_worker_dead", shard=w,
                            exitcode=exitcode,
                            delivered=self._shard_delivered[w],
                            consumed=self._shard_consumed[w])
                budget = get_env("MXTPU_DATA_WORKER_RESTARTS")
                if self._restarts >= budget:
                    raise DataPipelineError(
                        f"{source}: decode worker died (exit "
                        f"{exitcode}) and the restart budget is "
                        f"spent (restarted {self._restarts} "
                        "time(s), MXTPU_DATA_WORKER_RESTARTS="
                        f"{budget}); check for OOM kills or crashes "
                        "in native decode") from None
                self._restarts += 1
                telemetry.counter(
                    "data_service_worker_restarts_total").inc()
                trace_event("data_service_worker_restart", shard=w,
                            restart=self._restarts, budget=budget)
                warnings.warn(
                    f"{source}: decode worker died (exit "
                    f"{exitcode}); respawning from batch "
                    f"{self._shard_delivered[w]} (restart "
                    f"{self._restarts}/{budget})", RuntimeWarning)
                self._spawn_shard(w)

    def _consume_one(self):
        """Deliver the next merged batch as raw numpy
        (data, label, pad), advancing all cursors."""
        while True:
            if all(self._shard_done):
                raise StopIteration
            w = self._bidx % self._W
            if self._shard_done[w]:
                self._bidx += 1     # ghost slot: shard exhausted
                continue
            kind, filled, pad, consumed, bad, _seq, payload = \
                self._get_from_shard(w)
            self._rollup_bad(w, bad)
            if kind == _ring.KIND_ERROR:
                # an escaped raise can't know the stream cursor, so
                # the slot ships consumed=0 — keep the last good
                # cursor so a catch-then-checkpoint resumes exactly
                exc = payload
                if isinstance(exc, DataPipelineError):
                    raise exc
                err = DataPipelineError(
                    f"DataServiceIter({self._path}) shard {w} "
                    f"worker raised {type(exc).__name__}: {exc}")
                err.__cause__ = exc
                raise err
            self._shard_consumed[w] = consumed
            if kind == _ring.KIND_END:
                self._shard_done[w] = True
                continue
            self._shard_delivered[w] += 1
            self._bidx += 1
            self._publish(w, filled)
            return payload[0], payload[1], pad

    def _publish(self, w, filled):
        self._epoch_imgs += filled
        self._shard_imgs[w] += filled
        ctr = telemetry.counter("data_service_batches_total")
        if ctr is telemetry.NULL_METRIC:
            return      # disabled mode: zero registry writes
        ctr.inc()
        dt = time.monotonic() - self._epoch_t0
        if dt > 0:
            telemetry.gauge("data_service_img_per_sec").set(
                self._epoch_imgs / dt)
            telemetry.gauge(
                "data_service_shard%d_img_per_sec" % w).set(
                self._shard_imgs[w] / dt)
            if self._remotes:
                telemetry.gauge(
                    "data_service_remote_img_per_sec").set(
                    sum(self._shard_imgs[r]
                        for r in self._remotes) / dt)
        telemetry.gauge("data_service_ring_depth").set(
            sum(r.filled_depth() for r in self._rings))

    # ------------------------------------------------------------ iter
    def next(self):
        if self._resume_pending:
            self.reset()    # applies the restored position
        data, label, pad = self._consume_one()
        label_out = label[:, 0] if self.label_width == 1 else label
        return DataBatch([nd_array(data)], [nd_array(label_out)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        raise NotImplementedError("use next()")

    # ------------------------------------------------------------ intro
    def stats(self):
        """Operator view: aggregate + per-shard rates, ring depths,
        quarantine and restart accounting (docs/data_service.md)."""
        dt = max(time.monotonic() - self._epoch_t0, 1e-9)
        return {
            "img_per_sec": self._epoch_imgs / dt,
            "restarts": self._restarts,
            "bad_records": self._bad_total,
            "remote_shards": len(self._remotes),
            "shards": {
                w: {"img_per_sec": self._shard_imgs[w] / dt,
                    "delivered": self._shard_delivered[w],
                    "consumed": self._shard_consumed[w],
                    "ring_depth": self._rings[w].filled_depth(),
                    "bad_records": self._shard_bad[w],
                    "done": self._shard_done[w],
                    "remote": self._remotes[w].addr
                    if w in self._remotes else None}
                for w in range(self._W)},
        }

    # ------------------------------------------------------------ mgmt
    def close(self):
        """Stop workers and unlink every shm segment (idempotent);
        after this the iterator is dead."""
        if self._closed:
            return
        self._closed = True
        try:
            self._halt_workers()
        finally:
            for rs in self._remotes.values():
                rs.close()
            self._remotes = {}
            for r in self._rings:
                r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
