"""Remote data-service ranks (twin of
``incubator_mxnet_tpu/data_service/net.py``; docs/data_service.md
"Remote ranks").

Takes the sharded decode service multi-host: a
:class:`RemoteShardServer` (CLI:
``python -m incubator_mxnet_tpu_torch.data_service.net --shards N
--port-file PF``) runs a host's decode workers — the exact
``worker.py`` pipeline, rings and all — and streams finished batch
slots to the train host as frames over the shared CRC32-framed,
deadline-budgeted RPC (``rpc.py``).  The frames are the JAX
package's, so either package's server feeds either package's
client.  The train
side's :class:`RemoteShard` presents each remote stream behind the
same ``(kind, filled, pad, consumed, bad, seq, payload)`` contract as
``ShmBatchRing.get``, so ``DataServiceIter`` merges local shm shards
and remote socket shards round-robin with bit-identical order.

Backpressure is credit-based, mirroring the ring's semaphore
contract: the consumer grants ``MXTPU_DATA_NET_CREDITS`` (default:
the ring depth) in-flight frames at epoch start and returns one
credit per received frame; at zero credits the server's stream
thread blocks (in bounded poll slices), the ring behind it fills,
and the decode worker blocks on the ring's ``free`` semaphore — a
slow train host stalls the remote *producer*, never grows memory.

Failover semantics (poison the link, not the fleet): a garbled frame
(CRC mismatch, ``data_service:net`` ``corrupt``) or a host silent
past ``MXTPU_DATA_HOST_GRACE`` (``data_service:host`` ``kill``,
SIGKILL, network partition) raises
:class:`RemoteShardDown` for THAT shard only.  ``DataServiceIter``
then re-homes the shard — reconnect to the same host if it answers,
else a respawned local worker — from its last-delivered cursors
under the ``MXTPU_DATA_WORKER_RESTARTS`` budget, and the epoch
continues bit-identically (the worker's random draws are keyed to
global batch indices, so the frontier's location is invisible to
the stream).  Quarantine counts ride every frame, so the global
``MXTPU_MAX_BAD_RECORDS`` budget stays fleet-wide.

Every socket/semaphore wait in this module is deadline-bounded.
"""
import base64
import multiprocessing as _mp
import os
import threading
import time

import numpy as np

from .. import debugz, resilience, telemetry
from ..resilience import DataPipelineError
from ..rpc import (RpcClient, RpcError, RpcServer, RpcTimeoutError,
                   default_timeout)
from ..utils.env import get_env
from ..utils.log import get_logger
from . import ring as _ring
from .worker import worker_main

__all__ = ["RemoteShardServer", "RemoteShard", "RemoteShardDown",
           "main"]

logger = get_logger("data_service.net")

#: idle poll slice for client-side frame waits (the ring's
#: _POLL_S analog: death/deadline observed within one slice)
_POLL_S = 0.2
#: server->client liveness cadence while a stream has nothing to
#: send, and client->server ping cadence while waiting
_HB_S = 1.0
#: injection scope for the batch-frame send path (control frames
#: bypass injection: `nth frame` must count data frames only)
_NET_SCOPE = ("data_service", "net")


class RemoteShardDown(DataPipelineError):
    """This remote shard's link is poisoned or its host is gone —
    the supervisor's failover trigger (the wire analog of
    :class:`~.ring.RingProducerDead`)."""


def _b64(arr):
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()) \
        .decode("ascii")


def _host_grace():
    g = get_env("MXTPU_DATA_HOST_GRACE")
    return g if g > 0 else 10.0


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class _HostShard:
    """One shard stream on the serving host: a local decode worker +
    shm ring (the exact single-host machinery) plus a pump thread
    that forwards ring slots to the train host as frames, gated by
    the consumer's credits."""

    def __init__(self, ctx, conn, shard):
        self._ctx = ctx
        self._conn = conn
        self.shard = shard
        self._ring = None
        self._ring_key = None
        self._orphan_rings = []
        self._proc = None
        self._pipe = None
        self._pump = None
        self._pump_stop = threading.Event()
        self._credits = threading.Semaphore(0)
        self._stream = 0
        self._static = None
        self._clean = False
        self._epoch_imgs = 0
        self._epoch_t0 = time.monotonic()

    # ------------------------------------------------------- lifecycle
    def start_epoch(self, static, cmd, stream, credits):
        """(Re)start this shard at the cursors in ``cmd`` and stream
        its batches tagged ``stream``, with ``credits`` frames of
        send-ahead."""
        self._halt_pump()
        static = dict(static)
        static["decode"] = dict(static["decode"])
        static["decode"]["data_shape"] = tuple(
            static["decode"]["data_shape"])
        if self._proc is None or not self._proc.is_alive() \
                or not self._clean or static != self._static:
            self._respawn(static)
        self._static = static
        self._stream = int(stream)
        self._clean = False
        self._credits = threading.Semaphore(max(int(credits), 1))
        self._epoch_imgs = 0
        self._epoch_t0 = time.monotonic()
        self._pipe.send(cmd)
        self._pump_stop = threading.Event()
        t = threading.Thread(target=self._pump_loop,
                             name=f"data-net-pump-{self.shard}",
                             daemon=True)
        self._pump = t
        t.start()

    def grant(self, n):
        for _ in range(max(int(n), 0)):
            self._credits.release()

    def _ring_spec(self, static):
        return (static["batch_size"],
                tuple(static["decode"]["data_shape"]),
                static["label_width"],
                int(static.get("ring_depth",
                               get_env("MXTPU_DATA_RING_DEPTH"))))

    def _respawn(self, static):
        self._reap_worker()
        key = self._ring_spec(static)
        if self._ring is None or self._ring_key != key:
            if self._ring is not None:
                self._ring.close()
            bs, shape, lw, depth = key
            self._ring = _ring.ShmBatchRing(
                bs, shape, lw, max(depth, 1), self._ctx,
                tag=f"_r{self.shard}")
            self._ring_key = key
        else:
            self._ring.reset_sync()
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=worker_main,
            args=(self._ring, child_conn, static),
            daemon=True, name=f"mxtpu-data-net-{self.shard}")
        proc.start()
        child_conn.close()
        self._proc = proc
        self._pipe = parent_conn

    def _reap_worker(self):
        proc = self._proc
        if proc is None:
            return
        if self._ring is not None:
            self._ring.request_stop()
        try:
            self._pipe.send(None)
        except (OSError, ValueError, BrokenPipeError):
            pass
        proc.join(timeout=2)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
        try:
            self._pipe.close()
        except Exception:
            pass
        self._proc = None
        self._pipe = None

    def _halt_pump(self):
        self._pump_stop.set()
        t = self._pump
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
            if t.is_alive():
                # a pump wedged in a slow send still references this
                # ring: retire the segment instead of closing it out
                # from under a live reader (closed at teardown)
                if self._ring is not None:
                    self._orphan_rings.append(self._ring)
                self._ring = None
                self._ring_key = None
                self._clean = False
        self._pump = None

    def close(self):
        self._halt_pump()
        self._reap_worker()
        rings = list(self._orphan_rings)
        self._orphan_rings = []
        if self._ring is not None:
            rings.append(self._ring)
            self._ring = None
        for r in rings:
            r.close()

    # ------------------------------------------------------------ pump
    def _maybe_hb(self, last_tx):
        """Liveness while idle: the train host's grace timer must
        only expire for a host that is actually gone, not one whose
        decode is momentarily slow or credit-starved."""
        now = time.monotonic()
        if now - last_tx < _HB_S:
            return last_tx
        try:
            self._conn.send({"op": "hb", "shard": self.shard},
                            timeout=default_timeout(),
                            fault_scope=None)
        except RpcError:
            self._pump_stop.set()
        return now

    def _pump_loop(self):
        stop = self._pump_stop
        stream = self._stream
        ring = self._ring
        proc = self._proc
        src = f"RemoteShardServer shard {self.shard}"
        frames = telemetry.counter("data_service_net_frames_total")
        last_tx = time.monotonic()
        while not stop.is_set():
            # credit gate BEFORE the ring take: at zero credits the
            # slot stays in the ring and the worker blocks on `free`
            # — the semaphore contract, extended over the wire
            if not self._credits.acquire(timeout=_POLL_S):
                last_tx = self._maybe_hb(last_tx)
                continue
            got = None
            while got is None and not stop.is_set():
                try:
                    got = ring.get(src, proc.is_alive, _HB_S)
                except _ring.RingProducerDead:
                    # the remote host's OWN worker died: surface it
                    # to the train host, which re-homes the shard
                    # under the one global restart budget
                    try:
                        self._conn.send(
                            {"op": "down", "shard": self.shard,
                             "stream": stream,
                             "why": "decode worker died on the "
                                    "remote host"},
                            timeout=default_timeout(),
                            fault_scope=None)
                    except RpcError:
                        pass
                    return
                except DataPipelineError:
                    # slow decode, not death: keep the link warm so
                    # the consumer's grace timer never false-fires
                    last_tx = self._maybe_hb(last_tx)
            if got is None:
                return
            kind, filled, pad, consumed, bad, seq, payload = got
            # the deterministic host-death vector: the nth streamed
            # frame hard-kills this serving process (no teardown —
            # PDEATHSIG reaps the workers, the resource tracker the
            # rings), exactly what an OOM kill looks like
            resilience.inject("data_service", "host")
            msg = {"op": "batch", "shard": self.shard,
                   "stream": stream, "kind": kind, "filled": filled,
                   "pad": pad, "consumed": consumed, "bad": bad,
                   "seq": seq}
            if kind == _ring.KIND_DATA:
                msg["data"] = _b64(payload[0])
                msg["label"] = _b64(payload[1])
            elif kind == _ring.KIND_ERROR:
                msg["error"] = f"{type(payload).__name__}: {payload}"
            try:
                self._conn.send(msg, timeout=default_timeout(),
                                fault_scope=_NET_SCOPE)
            except RpcError:
                return      # train host gone; on_disconnect reaps us
            frames.inc()
            last_tx = time.monotonic()
            if kind == _ring.KIND_DATA:
                self._epoch_imgs += filled
                dt = time.monotonic() - self._epoch_t0
                if dt > 0:
                    telemetry.gauge(
                        "data_service_remote_img_per_sec").set(
                        self._epoch_imgs / dt)
            if kind == _ring.KIND_END:
                self._clean = True
                return


class RemoteShardServer:
    """One host's worth of remote decode shards behind the framed
    RPC (module docstring; CLI in :func:`main`).

    Protocol (all JSON frames):

    - ``epoch`` (client->server): ``static`` worker spec + ``cmd``
      epoch command (cursors included) + ``credits`` + ``stream``
      tag; (re)starts that shard's stream.
    - ``credit``: returns ``n`` send-ahead credits.
    - ``stop``: tears the shard's stream down (mid-epoch abandon).
    - ``ping``/``pong``: client-driven liveness probe.
    - ``batch`` (server->client): one ring slot — kind/cursors
      verbatim, pixel/label bytes base64 in the JSON payload, CRC32
      over the whole frame.
    - ``hb``: server-side liveness while a stream is idle.
    - ``down``: the shard's worker died server-side.
    """

    def __init__(self, host="127.0.0.1", port=0, max_shards=None,
                 name="data-net", poll=0.2):
        self._ctx = _mp.get_context("fork")
        self._max = int(max_shards if max_shards is not None
                        else get_env("MXTPU_DATA_WORKERS"))
        if self._max < 1:
            self._max = 1
        self._streams = {}       # (conn id, shard) -> _HostShard
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rpc = RpcServer(self._handle, host=host, port=port,
                              name=name, poll=poll,
                              on_disconnect=self._drop_conn,
                              fault_scope=None)

    @property
    def host(self):
        return self._rpc.host

    @property
    def port(self):
        return self._rpc.port

    def start(self):
        self._rpc.start()
        return self

    # ------------------------------------------------------- handlers
    def _prune_dead(self):
        """Drop streams whose connection already closed (their
        on_disconnect may still be in flight): a reconnecting client
        must not be refused capacity its own dead link is holding."""
        with self._lock:
            doomed = [(k, st) for k, st in self._streams.items()
                      if st._conn.closed]
            for k, _ in doomed:
                del self._streams[k]
        for _, st in doomed:
            st.close()

    def _handle(self, msg, conn, budget):
        op = msg.get("op")
        if op == "ping":
            return {"op": "pong"}
        shard = int(msg.get("shard", -1))
        key = (id(conn), shard)
        if op == "epoch":
            self._prune_dead()
            with self._lock:
                st = self._streams.get(key)
                active = len(self._streams)
            if st is None and active >= self._max:
                return {"op": "down", "shard": shard,
                        "stream": msg.get("stream"),
                        "why": f"capacity: {active}/{self._max} "
                               "shard streams active"}
            if st is None:
                st = _HostShard(self._ctx, conn, shard)
                with self._lock:
                    self._streams[key] = st
            st.start_epoch(msg["static"], msg["cmd"],
                           msg.get("stream", 0),
                           msg.get("credits", 1))
            return None
        if op == "credit":
            with self._lock:
                st = self._streams.get(key)
            if st is not None:
                st.grant(msg.get("n", 1))
            return None
        if op == "stop":
            with self._lock:
                st = self._streams.pop(key, None)
            if st is not None:
                st.close()
            return None
        return {"op": "error", "error": f"unknown op {op!r}"}

    def _drop_conn(self, conn):
        with self._lock:
            doomed = [k for k in self._streams if k[0] == id(conn)]
            sts = [self._streams.pop(k) for k in doomed]
        for st in sts:
            st.close()

    # ------------------------------------------------------ lifecycle
    def serve_forever(self):
        """Blocking serve loop for the CLI: heartbeat armed (rides
        ``MXTPU_HEARTBEAT_FILE`` for the launcher's hung-host kill),
        then park until :meth:`request_stop`."""
        resilience.start_heartbeat()
        self.start()
        # live introspection: shard cursors + ring state per active
        # stream (host-side bookkeeping under the server lock)
        debugz.maybe_start("data")
        debugz.register_provider("shards", self._debug_status)
        while not self._stop.is_set():
            self._stop.wait(timeout=_POLL_S)

    def _debug_status(self):
        with self._lock:
            items = list(self._streams.items())
        out = {}
        for (cid, shard), st in items:
            out[f"conn{cid}:shard{shard}"] = {
                "shard": st.shard,
                "epoch_imgs": st._epoch_imgs,
                "epoch_elapsed_s": round(
                    time.monotonic() - st._epoch_t0, 3),
                "clean": st._clean,
                "ring": st._ring is not None,
            }
        return out

    def request_stop(self):
        self._stop.set()

    def close(self):
        self._stop.set()
        self._rpc.close()
        with self._lock:
            sts = list(self._streams.values())
            self._streams.clear()
        for st in sts:
            st.close()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class RemoteShard:
    """Train-host handle for one remote shard: presents the wire
    stream behind ``ShmBatchRing.get``'s return contract so the
    ``DataServiceIter`` merge cannot tell transports apart."""

    def __init__(self, shard, addr, batch_size, data_shape,
                 label_width):
        self.shard = shard
        self.addr = str(addr)
        host, _, port = self.addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad remote data-service addr {addr!r}: want "
                "host:port (MXTPU_DATA_REMOTE_ADDRS)")
        self._host = host
        self._port = int(port)
        self._B = int(batch_size)
        self._shape = tuple(data_shape)
        self._lw = int(label_width)
        self._cli = None
        self._stream = 0
        self._last_rx = time.monotonic()

    @property
    def connected(self):
        return self._cli is not None and self._cli.connected

    def start_epoch(self, static, cmd, credits):
        """Send one epoch command at the cursors in ``cmd``;
        raises :class:`RemoteShardDown` when the host does not
        answer (the caller decides the failover target)."""
        if not self.connected:
            cli = RpcClient(self._host, self._port,
                            fault_scope=None)
            try:
                cli.connect(timeout=min(_host_grace(),
                                        default_timeout()))
            except RpcError as e:
                raise RemoteShardDown(
                    f"remote data host {self.addr} unreachable: "
                    f"{e}") from None
            self._cli = cli
        self._stream += 1
        try:
            self._cli.send(
                {"op": "epoch", "shard": self.shard,
                 "stream": self._stream, "static": static,
                 "cmd": cmd, "credits": int(credits)},
                fault_scope=None)
        except RpcError as e:
            raise RemoteShardDown(
                f"remote data host {self.addr} lost at epoch "
                f"start: {e}") from None
        self._last_rx = time.monotonic()

    def try_restart(self, static, cmd, credits):
        """One failover attempt against the same host on a FRESH
        connection (the poisoned one is gone for good); False means the
        host is really down and the shard must re-home elsewhere."""
        self.disconnect()
        try:
            self.start_epoch(static, cmd, credits)
            return True
        except RemoteShardDown:
            return False

    def get(self, source, timeout):
        """Next frame for this shard as a ring-shaped tuple
        ``(kind, filled, pad, consumed, bad, seq, payload)``.

        Bounded the same way ``ring.get`` is: short recv slices so
        host death (:class:`RemoteShardDown` — the failover
        trigger) surfaces within ``MXTPU_DATA_HOST_GRACE``, and the
        operator-facing ``MXTPU_DATA_TIMEOUT`` deadline raises a
        plain :class:`DataPipelineError`."""
        if self._cli is None:
            raise RemoteShardDown(
                f"{source}: no connection to {self.addr}")
        deadline = time.monotonic() + timeout \
            if timeout and timeout > 0 else None
        grace = _host_grace()
        last_ping = 0.0
        frames = telemetry.counter("data_service_net_frames_total")
        while True:
            try:
                msg, _budget = self._cli.recv(timeout=_POLL_S)
            except RpcTimeoutError:
                now = time.monotonic()
                if now - self._last_rx > grace:
                    raise RemoteShardDown(
                        f"{source}: {self.addr} silent past "
                        f"MXTPU_DATA_HOST_GRACE={grace:g}s (no "
                        "batch, heartbeat, or pong)") from None
                if now - last_ping >= _HB_S:
                    last_ping = now
                    try:
                        self._cli.send({"op": "ping"},
                                       fault_scope=None)
                    except RpcError as e:
                        raise RemoteShardDown(
                            f"{source}: {self.addr} link lost: "
                            f"{e}") from None
                if deadline is not None and now >= deadline:
                    raise DataPipelineError(
                        f"{source} stalled: no batch arrived "
                        f"within {timeout:g}s (MXTPU_DATA_TIMEOUT) "
                        f"from {self.addr}; the remote decode host "
                        "or its storage is wedged — raise the "
                        "timeout for slow sources, or inspect the "
                        "host named above") from None
                continue
            except RpcError as e:
                # RpcFrameError lands here too: a garbled frame
                # poisons THIS link only, and the socket is already
                # closed by the client wrapper
                raise RemoteShardDown(
                    f"{source}: connection to {self.addr} "
                    f"poisoned: {e}") from None
            self._last_rx = time.monotonic()
            op = msg.get("op")
            if op in ("pong", "hb"):
                continue
            if op == "down":
                raise RemoteShardDown(
                    f"{source}: {self.addr} reports shard down: "
                    f"{msg.get('why')}")
            if op == "error":
                raise RemoteShardDown(
                    f"{source}: {self.addr} server error: "
                    f"{msg.get('error')}")
            if op != "batch" \
                    or int(msg.get("stream", -1)) != self._stream:
                continue    # stale frame from a superseded stream
            # frame consumed -> return its credit (the wire analog
            # of ring._take's `free` release)
            try:
                self._cli.send(
                    {"op": "credit", "shard": self.shard,
                     "stream": self._stream, "n": 1},
                    fault_scope=None)
            except RpcError:
                pass      # a dead link surfaces on the next recv
            frames.inc()
            return self._decode(msg, source)

    def _decode(self, msg, source):
        kind = int(msg["kind"])
        filled = int(msg.get("filled", 0))
        pad = int(msg.get("pad", 0))
        consumed = int(msg.get("consumed", 0))
        bad = int(msg.get("bad", 0))
        seq = int(msg.get("seq", 0))
        payload = None
        if kind == _ring.KIND_DATA:
            data = np.frombuffer(
                base64.b64decode(msg["data"]), np.float32)
            label = np.frombuffer(
                base64.b64decode(msg["label"]), np.float32)
            payload = (data.reshape((self._B,) + self._shape),
                       label.reshape((self._B, self._lw)))
        elif kind == _ring.KIND_ERROR:
            payload = DataPipelineError(
                f"{source}: remote decode worker on {self.addr} "
                f"raised: {msg.get('error')}")
        return kind, filled, pad, consumed, bad, seq, payload

    def stop_stream(self):
        """Best-effort mid-epoch abandon (the `_reap_shard` analog);
        the connection stays up for the next epoch command."""
        if self.connected:
            try:
                self._cli.send({"op": "stop", "shard": self.shard},
                               fault_scope=None)
            except RpcError:
                pass

    def disconnect(self):
        cli, self._cli = self._cli, None
        if cli is not None:
            cli.close()

    def close(self):
        self.stop_stream()
        self.disconnect()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    """``python -m incubator_mxnet_tpu_torch.data_service.net`` — run one
    host's remote decode shards until SIGTERM/SIGINT.  The port-file
    handshake (write to ``.tmp``, rename) mirrors the replica CLI so
    ``tools/launch.py --data-hosts`` can pick up an ephemeral port
    race-free."""
    import argparse
    import signal
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_tpu_torch.data_service.net",
        description="remote data-service shard server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral; pair with "
                         "--port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here (atomic rename)")
    ap.add_argument("--shards", type=int, default=None,
                    help="max concurrent shard streams this host "
                         "serves (default MXTPU_DATA_WORKERS)")
    ap.add_argument("--name", default="data-net")
    args = ap.parse_args(argv)
    srv = RemoteShardServer(host=args.host, port=args.port,
                            max_shards=args.shards, name=args.name)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(srv.port))
        os.replace(tmp, args.port_file)
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: srv.request_stop())
    logger.info("RemoteShardServer listening on %s:%d (shards=%d)",
                srv.host, srv.port, srv._max)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
