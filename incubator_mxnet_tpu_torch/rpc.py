"""Shared framed RPC transport (the ps-lite van role; twin of
``incubator_mxnet_tpu/rpc.py``: the frame bytes are the same, so a
client of either package talks to a server of the other).

One frame = a fixed struct header + a JSON payload:

    !4sIId  ->  magic  b"MXRF"
                payload length (bytes)
                CRC32 of the payload
                remaining deadline budget (s, float64; 0 = none)

The CRC makes corruption *detectable* (a garbled frame raises
:class:`RpcFrameError` and the receiver drops the connection — once
framing is suspect the whole stream is) and the header's float64
propagates the *remaining* per-request deadline across the process
boundary, so a request re-dispatched after a replica death runs under
what is left of its budget, not a fresh one (docs/serving.md "Fleet").

Two planes speak this transport: the serving fleet
(``serving/rpc.py``, ``serving/router.py``, ``serving/replica.py``) and
the remote data-service ranks (``data_service/net.py``,
docs/data_service.md "Remote ranks").  The only plane-specific knob
is the fault-injection scope: the frame *send* path consults
``fault_scope`` (default ``("router", "net")``; the data plane's
batch stream passes ``("data_service", "net")``, control frames pass
``None`` to skip injection) — ``corrupt`` garbles one payload byte
after the CRC is computed (the receiver rejects the frame), ``error``
drops the frame and closes the connection, ``hang`` delays it by
MXTPU_FAULT_HANG_S (the caller's deadline decides the outcome).

Every socket wait is bounded: each operation computes the remaining
per-call budget (``MXTPU_RPC_TIMEOUT`` by default) and arms
``settimeout`` before touching the socket.  Timeouts raise :class:`RpcTimeoutError`
(a :class:`~.resilience.DeadlineExceededError`), transport failures
:class:`RpcError`; reconnects back off with full jitter
(``RetryPolicy(jitter=True)``) so N replicas re-homing after a router
blip do not retry in lockstep.
"""
import json
import select
import socket
import struct
import threading
import time
import zlib

from . import resilience, telemetry
from .utils.env import get_env
from .utils.log import get_logger

logger = get_logger("rpc")

MAGIC = b"MXRF"
_HEADER = struct.Struct("!4sIId")
#: refuse absurd frame lengths before allocating (a corrupted length
#: field must not look like an OOM)
MAX_FRAME_BYTES = 64 << 20

#: default injection point for the frame send path (the serving
#: fleet's scope); pass fault_scope=None to bypass injection
DEFAULT_FAULT_SCOPE = ("router", "net")
_SCOPE_UNSET = object()

_m_frame_errors = telemetry.counter("rpc_frame_errors_total")
_m_frames_sent = telemetry.counter("rpc_frames_sent_total")
_m_reconnects = telemetry.counter("rpc_reconnects_total")


class RpcError(resilience.ResilienceError):
    """Transport-level RPC failure (peer gone, send/recv failed)."""


class RpcTimeoutError(RpcError, resilience.DeadlineExceededError):
    """An RPC socket wait exceeded its per-call deadline."""


class RpcFrameError(RpcError):
    """A received frame failed validation (magic, length, CRC,
    payload decode).  The connection is considered poisoned — framing
    can no longer be trusted — so receivers close it and let the peer
    reconnect."""


def default_timeout():
    """The mandatory per-call deadline (s).  ``MXTPU_RPC_TIMEOUT``;
    non-positive values are coerced to 30 s — this layer never waits
    unbounded."""
    t = get_env("MXTPU_RPC_TIMEOUT")
    return t if t > 0 else 30.0


def _deadline(timeout):
    """Monotonic deadline stamp for one call."""
    return time.monotonic() + (default_timeout()
                               if timeout is None else timeout)


def _remaining(deadline, what):
    rem = deadline - time.monotonic()
    if rem <= 0:
        raise RpcTimeoutError(f"rpc deadline exceeded during {what}")
    return rem


def encode_frame(msg, budget=0.0):
    """Serialize one message dict to wire bytes (header + JSON)."""
    payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise RpcFrameError(
            f"frame payload {len(payload)}B exceeds "
            f"{MAX_FRAME_BYTES}B")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    header = _HEADER.pack(MAGIC, len(payload), crc, float(budget))
    return header, payload


def send_frame(sock, msg, budget=0.0, timeout=None, lock=None,
               fault_scope=DEFAULT_FAULT_SCOPE):
    """Send one frame with a bounded deadline.

    ``budget`` is the remaining per-request deadline to propagate in
    the header (0 = none).  ``lock`` (if given) serializes writers on
    a shared socket.  ``fault_scope`` names the ``MXTPU_FAULT_SPEC``
    injection point consulted here (``("router", "net")`` for the
    serving fleet, ``("data_service", "net")`` for the data plane's
    batch stream, ``None`` to bypass): the CRC is computed over the
    *clean* payload first, so an injected ``corrupt`` flips a byte
    the receiver's CRC check catches.
    """
    deadline = _deadline(timeout)
    header, payload = encode_frame(msg, budget)
    kind = resilience.fault_for(*fault_scope) \
        if fault_scope is not None else None
    if kind == "corrupt":
        # garble one payload byte AFTER the CRC was computed: the
        # receiver must reject the frame and drop the connection
        payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
    elif kind == "error":
        # drop the frame on the floor and poison the link, like a
        # mid-write connection reset
        try:
            sock.close()
        except OSError:
            pass
        raise RpcError(
            "injected frame drop for %s:%s" % fault_scope)
    elif kind == "hang":
        # a delayed frame: the caller's deadline, not this sleep,
        # decides the request's fate
        time.sleep(get_env("MXTPU_FAULT_HANG_S"))
    data = header + payload
    lock = lock if lock is not None else threading.Lock()
    with lock:
        try:
            sock.settimeout(_remaining(deadline, "send"))
            sock.sendall(data)
        except (socket.timeout, TimeoutError):
            raise RpcTimeoutError(
                "rpc deadline exceeded during send") from None
        except OSError as e:
            raise RpcError(f"rpc send failed: {e}") from None
    _m_frames_sent.inc()


def _recv_exact(sock, n, deadline, what):
    buf = bytearray()
    while len(buf) < n:
        try:
            sock.settimeout(_remaining(deadline, what))
            # deadline-ok: settimeout armed above from the deadline
            chunk = sock.recv(n - len(buf))
        except (socket.timeout, TimeoutError):
            if buf:
                # a MID-FRAME timeout already consumed bytes the
                # next read can never re-frame: the stream is
                # desynchronized, not merely idle — poison it
                raise RpcError(
                    f"rpc stream desynchronized: timeout mid-"
                    f"{what} after {len(buf)}/{n} bytes") from None
            raise RpcTimeoutError(
                f"rpc deadline exceeded during {what}") from None
        except OSError as e:
            raise RpcError(f"rpc recv failed: {e}") from None
        if not chunk:
            raise RpcError("connection closed by peer")
        buf += chunk
    return bytes(buf)


def recv_frame(sock, timeout=None):
    """Receive one frame; returns ``(msg, budget)``.

    ``timeout`` bounds the wait for the frame to *start* (reader
    loops poll with a short one — :class:`RpcTimeoutError` then just
    means "idle tick", and crucially consumes nothing).  Once the
    first byte is in flight the frame gets the full default deadline
    to complete; a timeout mid-frame has consumed bytes the stream
    cannot re-frame, so it poisons the connection (:class:`RpcError`)
    instead of pretending the link is idle.

    Raises :class:`RpcFrameError` on any validation failure —
    callers must treat the connection as poisoned afterwards.
    """
    wait = default_timeout() if timeout is None else timeout
    try:
        # deadline-ok: select bounded by the poll/call timeout;
        # consumes nothing, so a timeout here leaves framing intact
        ready, _, _ = select.select([sock], [], [], max(wait, 0.0))
    except (OSError, ValueError) as e:
        raise RpcError(f"rpc recv failed: {e}") from None
    if not ready:
        raise RpcTimeoutError(
            "rpc deadline exceeded waiting for a frame")
    deadline = _deadline(None)
    raw = _recv_exact(sock, _HEADER.size, deadline, "recv header")
    magic, length, crc, budget = _HEADER.unpack(raw)
    if magic != MAGIC:
        _m_frame_errors.inc()
        raise RpcFrameError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME_BYTES:
        _m_frame_errors.inc()
        raise RpcFrameError(f"frame length {length}B exceeds "
                            f"{MAX_FRAME_BYTES}B")
    payload = _recv_exact(sock, length, deadline, "recv payload")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        _m_frame_errors.inc()
        raise RpcFrameError("frame CRC mismatch (corrupted payload)")
    try:
        msg = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        _m_frame_errors.inc()
        raise RpcFrameError(f"frame payload decode failed: {e}") \
            from None
    return msg, budget


class RpcClient:
    """One outbound connection speaking the frame protocol.

    Thread contract: any number of threads may :meth:`send` (writes
    are lock-serialized); at most ONE thread may :meth:`recv` (the
    link's reader).  :meth:`call` (send + one reply) is only safe
    when no concurrent reader owns the socket.
    """

    def __init__(self, host, port, timeout=None,
                 fault_scope=DEFAULT_FAULT_SCOPE):
        self.host = host
        self.port = int(port)
        self.timeout = (default_timeout()
                        if timeout is None else float(timeout))
        self.fault_scope = fault_scope
        self._sock = None
        self._send_lock = threading.Lock()

    @property
    def connected(self):
        return self._sock is not None

    def connect(self, timeout=None):
        """One bounded connection attempt (no retries)."""
        self.close()
        rem = self.timeout if timeout is None else timeout
        try:
            # deadline-ok: create_connection bounded by timeout arg
            sock = socket.create_connection(
                (self.host, self.port), timeout=rem)
        except (socket.timeout, TimeoutError):
            raise RpcTimeoutError(
                f"rpc connect to {self.host}:{self.port} timed "
                "out") from None
        except OSError as e:
            raise RpcError(
                f"rpc connect to {self.host}:{self.port} failed: "
                f"{e}") from None
        if sock.getsockname() == sock.getpeername():
            # TCP self-connect: a local port in the ephemeral range with
            # nothing listening (a dead replica's) can hand a retrying
            # client its own socket; the link would echo its frames
            sock.close()
            raise RpcError(f"rpc connect to {self.host}:{self.port} "
                           "reached itself (nothing listens there)")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        return self

    def connect_retry(self, policy=None):
        """Connect with full-jitter backoff: the reconnect path N
        replicas/links share after a blip, so deterministic backoff
        would retry in lockstep (thundering herd)."""
        if policy is None:
            policy = resilience.RetryPolicy(jitter=True)
        _m_reconnects.inc()
        resilience.retry_call(
            self.connect, policy=policy, retry_on=(RpcError,),
            op_name=f"rpc_connect:{self.host}:{self.port}")
        return self

    def send(self, msg, budget=0.0, timeout=None,
             fault_scope=_SCOPE_UNSET):
        if self._sock is None:
            raise RpcError("rpc client not connected")
        try:
            send_frame(self._sock, msg, budget=budget,
                       timeout=self.timeout if timeout is None
                       else timeout,
                       lock=self._send_lock,
                       fault_scope=self.fault_scope
                       if fault_scope is _SCOPE_UNSET
                       else fault_scope)
        except RpcError:
            self.close()
            raise

    def recv(self, timeout=None):
        if self._sock is None:
            raise RpcError("rpc client not connected")
        try:
            return recv_frame(self._sock,
                              timeout=self.timeout if timeout is None
                              else timeout)
        except RpcTimeoutError:
            raise            # socket still healthy: caller may poll again
        except RpcError:
            self.close()
            raise

    def call(self, msg, budget=0.0, timeout=None):
        """Send one frame and wait for one reply frame (single
        caller only — see the thread contract)."""
        t = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + t
        self.send(msg, budget=budget, timeout=t)
        return self.recv(timeout=_remaining(deadline, "call reply"))

    def close(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def call_once(host, port, msg, timeout=None):
    """Connect, send one frame, wait for one reply, close — under a
    single monotonic deadline covering all three phases.  The
    one-shot shape debugz/status pollers need: a SIGSTOPped peer
    costs at most ``timeout`` seconds, never a wedged caller."""
    t = default_timeout() if timeout is None else float(timeout)
    deadline = time.monotonic() + t
    cli = RpcClient(host, port, timeout=t, fault_scope=None)
    try:
        cli.connect(timeout=_remaining(deadline, "call_once connect"))
        return cli.call(msg, timeout=_remaining(deadline,
                                                "call_once reply"))
    finally:
        cli.close()


class _Conn:
    """Server-side handle for one accepted connection."""

    def __init__(self, sock, peer, fault_scope=DEFAULT_FAULT_SCOPE):
        self.sock = sock
        self.peer = peer
        self.fault_scope = fault_scope
        self._send_lock = threading.Lock()
        self._closed = False

    def send(self, msg, budget=0.0, timeout=None,
             fault_scope=_SCOPE_UNSET):
        if self._closed:
            raise RpcError(f"connection to {self.peer} closed")
        try:
            send_frame(self.sock, msg, budget=budget,
                       timeout=timeout, lock=self._send_lock,
                       fault_scope=self.fault_scope
                       if fault_scope is _SCOPE_UNSET
                       else fault_scope)
        except RpcError:
            self.close()
            raise

    def close(self):
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def closed(self):
        return self._closed


class RpcServer:
    """Threaded frame server.

    ``handler(msg, conn, budget)`` runs on the per-connection reader
    thread; a non-None return value is sent back on the same
    connection.  A frame that fails validation poisons its
    connection: the server closes it (and counts
    ``rpc_frame_errors_total``) and the peer reconnects — subsequent
    requests are not poisoned because state lives above the
    transport.  ``fault_scope`` is the default injection point for
    replies sent on this server's connections (see
    :func:`send_frame`).
    """

    def __init__(self, handler, host="127.0.0.1", port=0,
                 name="rpc", poll=0.2, on_disconnect=None,
                 fault_scope=DEFAULT_FAULT_SCOPE):
        self._handler = handler
        self._name = name
        self._poll = poll
        self._on_disconnect = on_disconnect
        self._fault_scope = fault_scope
        self._stop = threading.Event()
        self._conns = []
        self._threads = []
        self._lock = threading.Lock()
        self._lsock = socket.socket(socket.AF_INET,
                                    socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET,
                               socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(16)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._accept_thread = None

    def start(self):
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"{self._name}-accept", daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        self._lsock.settimeout(self._poll)
        while not self._stop.is_set():
            try:
                # deadline-ok: settimeout(poll) above bounds accept
                sock, addr = self._lsock.accept()
            except (socket.timeout, TimeoutError):
                continue
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP,
                            socket.TCP_NODELAY, 1)
            conn = _Conn(sock, f"{addr[0]}:{addr[1]}",
                         fault_scope=self._fault_scope)
            t = threading.Thread(
                target=self._reader_loop, args=(conn,),
                name=f"{self._name}-conn", daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _reader_loop(self, conn):
        while not self._stop.is_set() and not conn.closed:
            try:
                msg, budget = recv_frame(conn.sock,
                                         timeout=self._poll)
            except RpcTimeoutError:
                continue             # idle poll tick, link healthy
            except RpcFrameError as e:
                logger.warning("%s: dropping poisoned connection "
                               "from %s: %s", self._name, conn.peer,
                               e)
                conn.close()
                break
            except (RpcError, OSError):
                conn.close()
                break
            try:
                reply = self._handler(msg, conn, budget)
            except Exception as e:     # noqa: BLE001 — handler bugs must not kill the reader
                logger.exception("%s: handler failed for op=%r",
                                 self._name, msg.get("op"))
                try:
                    conn.send({"op": "error", "error": str(e)})
                except RpcError:
                    break
                continue
            if reply is not None:
                try:
                    conn.send(reply)
                except RpcError:
                    break
        if self._on_disconnect is not None:
            try:
                self._on_disconnect(conn)
            except Exception:          # noqa: BLE001 — teardown callback must not raise
                logger.exception("%s: on_disconnect failed",
                                 self._name)

    def connections(self):
        with self._lock:
            return [c for c in self._conns if not c.closed]

    def close(self):
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            c.close()
        for t in threads:
            t.join(timeout=2.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
