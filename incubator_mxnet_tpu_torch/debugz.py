"""Live introspection plane: the per-process ``debugz`` endpoint (twin
of ``incubator_mxnet_tpu/debugz.py``).

Every long-running process — in the port so far the remote
data-service shard servers — embeds one read-only debug endpoint served over the CRC-framed,
deadline-budgeted :mod:`.rpc` transport.  A fleet operator (or
``tools/launch.py``'s status ticks) can ask a *live, possibly
wedged* process "what are you doing right now" instead of waiting
for heartbeat-file mtimes or post-mortem flight-recorder dumps.

Ops (request ``{"op": <name>, ...}`` → one reply frame):

``varz``      full telemetry snapshot (counters/gauges/histograms)
``statusz``   role-specific live state from registered providers
              plus push-published train-loop fields
``tracez``    flight-recorder tail, filterable by ``event``/``rid``
``memz``      memory gauges + the analytic :class:`MemoryPlan`
``profilez``  arm the chrome-tracing profiler for N seconds and
              return the dump inline
``healthz``   own-heartbeat age + anomaly-watchdog verdicts

Contract:

* **read-only** — no op mutates model / engine / stream state
  (``profilez`` toggles only the profiler recorder);
* **zero device syncs** — every payload is host-side Python data;
  an op never waits on the card;
* **deadline-bounded** — handlers run inline on the rpc reader
  thread and do only bounded work, so the caller's own socket
  deadline is the only wait anywhere.  A SIGSTOPped process simply
  never answers; it cannot wedge the caller.

Stdlib-only at import time.  A forked child drops the parent's
endpoint (its threads did not survive the fork) and re-creates the
lock.
"""

import os
import tempfile
import threading
import time

from . import rpc
from . import resilience
from . import telemetry
from . import tracing
from .utils.env import get_env

__all__ = [
    "OPS",
    "DebugzServer",
    "maybe_start",
    "port",
    "publish",
    "register_provider",
    "server",
    "stop",
]

#: every op the endpoint answers (the docs/observability.md
#: introspection catalog)
OPS = ("varz", "statusz", "tracez", "memz", "profilez", "healthz")

#: hard cap on profilez arming (seconds) — keeps the op bounded even
#: against an absurd request
PROFILEZ_MAX_S = 30.0

_LOCK = threading.Lock()
_STATE = {"server": None}
_PROVIDERS = {}      # name -> zero-arg callable returning a dict
_PUBLISHED = {}      # name -> dict merged by publish()


# ---------------------------------------------------------------------------
# role-specific state sources
# ---------------------------------------------------------------------------


def register_provider(name, fn):
    """Register a zero-arg callable whose dict return feeds
    ``statusz`` under ``name`` (engine stats, router stats, shard
    cursors...).  The callable runs on the debugz reader thread and
    must be host-side and non-blocking.  Returns an unregister
    callable; re-registering a name replaces the old source."""
    with _LOCK:
        _PROVIDERS[name] = fn

    def unregister():
        with _LOCK:
            if _PROVIDERS.get(name) is fn:
                del _PROVIDERS[name]
    return unregister


def publish(name, **fields):
    """Push-style counterpart of :func:`register_provider` for code
    with no natural object to poll — the train loop publishes
    ``step``/``epoch``/last timeline split after each step and
    ``statusz`` serves the latest merge."""
    with _LOCK:
        d = _PUBLISHED.setdefault(name, {})
        d.update(fields)


def _status_payload():
    with _LOCK:
        providers = dict(_PROVIDERS)
        published = {k: dict(v) for k, v in _PUBLISHED.items()}
    out = dict(published)
    for name, fn in providers.items():
        try:
            out[name] = fn()
        except Exception as e:  # one broken source must not take
            out[name] = {"error": str(e)}  # down the whole statusz
    return out


# ---------------------------------------------------------------------------
# the endpoint
# ---------------------------------------------------------------------------


class DebugzServer:
    """Read-only debug endpoint for one process (see module doc)."""

    def __init__(self, role, host="127.0.0.1", port=0):
        self.role = role
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        # fault_scope=None: injected router/net faults must never
        # corrupt the plane used to debug them
        self._srv = rpc.RpcServer(
            self._handle, host=host, port=int(port),
            name=f"debugz-{role}", fault_scope=None)

    @property
    def host(self):
        return self._srv.host

    @property
    def port(self):
        return self._srv.port

    def start(self):
        self._srv.start()
        return self

    def close(self):
        self._stop.set()
        self._srv.close()

    # -- dispatch ----------------------------------------------------------

    def _handle(self, msg, conn, budget):
        op = msg.get("op")
        if op not in OPS:
            return {"op": "error",
                    "error": f"unknown debugz op: {op!r}",
                    "ops": list(OPS)}
        reply = getattr(self, "_op_" + op)(msg)
        reply.setdefault("op", op)
        reply["role"] = self.role
        reply["rank"] = int(os.environ.get("MXTPU_WORKER_RANK", 0))
        reply["uptime_s"] = round(time.monotonic() - self._t0, 3)
        return reply

    # -- ops ---------------------------------------------------------------

    def _op_varz(self, msg):
        return {"telemetry": telemetry.snapshot()}

    def _op_statusz(self, msg):
        return {"status": _status_payload()}

    def _op_tracez(self, msg):
        match = {}
        if msg.get("rid") is not None:
            match["rid"] = msg["rid"]
        evs = tracing.events(event=msg.get("event"), **match)
        limit = int(msg.get("limit") or 0)
        if limit > 0:
            evs = evs[-limit:]
        return {"events": evs,
                "dropped": tracing.get_recorder().dropped}

    def _op_memz(self, msg):
        # device_memory_stats is metadata-only (live_bytes walks
        # already-materialised buffer sizes; no transfer, no sync)
        return {"memory": tracing.device_memory_stats(),
                "plan": tracing.memory_plan()}

    def _op_profilez(self, msg):
        seconds = float(msg.get("seconds") or 1.0)
        seconds = max(0.0, min(seconds, PROFILEZ_MAX_S))
        from . import profiler
        if profiler._profiler.running:
            return {"error": "profiler busy (already running)"}
        prev = profiler._profiler.filename
        path = os.path.join(
            tempfile.gettempdir(),
            f"mxtpu-debugz-profile-{os.getpid()}.json")
        profiler.set_config(filename=path)
        profiler.set_state("run")
        try:
            # bounded by PROFILEZ_MAX_S; wakes early on close()
            self._stop.wait(seconds)
        finally:
            profiler.set_state("stop")
            profiler.dump_profile()
            profiler.set_config(filename=prev)
        try:
            with open(path) as f:
                dump = f.read()
        except OSError as e:
            return {"error": f"profile dump unreadable: {e}"}
        return {"profile": dump, "seconds": seconds}

    def _op_healthz(self, msg):
        age = resilience.heartbeat_age()
        verdicts = telemetry.anomaly_verdicts()
        anomalous = any(v.get("anomalous") for v in verdicts.values())
        return {"heartbeat_age_s":
                None if age is None else round(age, 3),
                "anomaly": verdicts,
                "anomalous": anomalous,
                "ok": not anomalous}


# ---------------------------------------------------------------------------
# process-wide lifecycle
# ---------------------------------------------------------------------------


def maybe_start(role):
    """Start this process's endpoint once (idempotent), gated on
    ``MXTPU_DEBUGZ``.  Binds ``MXTPU_DEBUGZ_PORT`` (0 = ephemeral)
    and, when ``MXTPU_DEBUGZ_PORTFILE`` is set (launch.py exports a
    per-rank path), publishes ``host:port`` there via the atomic
    temp+rename handshake.  Returns the server, or None when
    disabled or the bind fails — introspection must never kill the
    process it introspects."""
    if not get_env("MXTPU_DEBUGZ"):
        return None
    with _LOCK:
        if _STATE["server"] is not None:
            return _STATE["server"]
    try:
        srv = DebugzServer(role,
                           port=get_env("MXTPU_DEBUGZ_PORT")).start()
    except OSError:
        return None
    with _LOCK:
        if _STATE["server"] is not None:  # lost a startup race
            srv.close()
            return _STATE["server"]
        _STATE["server"] = srv
    portfile = get_env("MXTPU_DEBUGZ_PORTFILE")
    if portfile:
        try:
            tmp = portfile + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{srv.host}:{srv.port}\n")
            os.replace(tmp, portfile)
        except OSError:
            pass
    return srv


def server():
    """The running endpoint, or None."""
    with _LOCK:
        return _STATE["server"]


def port():
    """Bound port of the running endpoint, or None."""
    srv = server()
    return None if srv is None else srv.port


def stop():
    """Close the endpoint and clear provider/publish registries
    (tests / clean shutdown)."""
    with _LOCK:
        srv = _STATE["server"]
        _STATE["server"] = None
        _PROVIDERS.clear()
        _PUBLISHED.clear()
    if srv is not None:
        srv.close()


def _after_fork_in_child():
    """A forked child owns none of the parent's endpoint threads:
    forget the server (its listening socket stays the parent's) and
    take a fresh lock."""
    global _LOCK
    _LOCK = threading.Lock()
    _STATE["server"] = None


os.register_at_fork(after_in_child=_after_fork_in_child)
