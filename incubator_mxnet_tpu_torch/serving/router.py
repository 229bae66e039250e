"""Fleet router: spread requests over N replicas, survive their deaths
(twin of ``incubator_mxnet_tpu/serving/router.py``; the frames are the
JAX package's, so either package's router drives either package's
replicas).  Pure host code: it touches no tensor and no device.

:class:`ServingRouter` owns one RPC link per replica
(``serving/rpc.py``) and gives the fleet the same request contract one
:class:`~.engine.ServingEngine` gives a process:

- **Typed admission.**  Fleet-wide queue/token budgets shed at the
  door with the same :class:`ServeRejectedError` the engine raises —
  traffic code cannot tell a fleet from a single engine.
- **Prefix-cache-aware routing.**  The prompt's leading full blocks
  are rolled into the same chain hashes
  :class:`~.cache_manager.PrefixCache` uses (seed ``0x5eed``); the
  replica that most recently served the longest matching chain gets
  the request (its cache likely still holds those blocks), falling
  back to the least-queued healthy replica.
- **Health + circuit breaker.**  Every frame from a replica
  refreshes its link's heartbeat; pings measure EWMA latency.
  Consecutive dispatch failures trip a closed -> open breaker
  (``MXTPU_BREAKER_THRESHOLD``); after
  ``MXTPU_BREAKER_COOLDOWN`` seconds half-open admits EXACTLY one
  probe request — success closes the breaker, failure re-opens it.
- **Failover re-dispatch.**  When a replica dies (link drop, frame
  corruption, staleness) its in-flight requests are re-dispatched to
  survivors carrying their *remaining* deadline budgets and the
  tokens generated so far — greedy recompute makes the continuation
  token-identical.  Dispatch generations dedup stale frames, so a
  request is never duplicated; the router's single finalize point
  plus a deadline net (a request past its deadline with a wedged
  owner expires locally) means every admitted request ends in
  exactly one terminal state fleet-wide, never silently lost.

All timing is monotonic-clock and every socket wait is bounded;
deadlines cross the wire as REMAINING seconds.  SIGTERM latches drain:
admission stops, every replica snapshots and drains, and the fleet can
be restored replica by replica (``ServingEngine.restore``).
"""
import os
import threading
import time

from .. import debugz, telemetry, tracing
from ..utils.env import get_env
from ..utils.log import get_logger
from . import rpc
from .cache_manager import _SEED
from .scheduler import (EXPIRED, FAILED, ServeRejectedError,
                        TERMINAL_STATES)

logger = get_logger("serving.router")

_m_requests = telemetry.counter("router_requests_total")
_m_rejected = telemetry.counter("router_rejected_total")
_m_redispatch = telemetry.counter("router_redispatches_total")
_m_rep_fail = telemetry.counter("router_replica_failures_total")
_m_breaker_open = telemetry.counter("router_breaker_open_total")
_m_healthy = telemetry.gauge("fleet_healthy_replicas")
_m_failover = telemetry.histogram("router_failover_seconds")

#: affinity map bound: oldest prefix-chain entries fall off first so
#: a long-lived router cannot grow without bound
_AFFINITY_CAP = 8192


class FleetRequest:
    """Router-side view of one admitted request."""

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_id",
                 "generated", "state", "error", "ttft_done",
                 "submit_ts", "first_token_ts", "deadline_ts",
                 "ttft_deadline_ts", "link", "gen", "redispatches",
                 "done_event", "sink", "_redispatch_ts")

    def __init__(self, rid, prompt, max_new_tokens, eos_id=None):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.generated = []
        self.state = "queued"
        self.error = None
        self.ttft_done = False
        self.submit_ts = time.monotonic()
        self.first_token_ts = None
        self.deadline_ts = None
        self.ttft_deadline_ts = None
        self.link = None          # name of the replica that owns it
        self.gen = 0              # dispatch generation (dedup)
        self.redispatches = 0
        self.done_event = threading.Event()
        self.sink = None          # front-door conn to stream to
        self._redispatch_ts = None

    @property
    def done(self):
        return self.state in TERMINAL_STATES

    @property
    def tokens(self):
        return list(self.prompt) + list(self.generated)


class _Breaker:
    """Closed / open / half-open circuit breaker, monotonic clock.

    ``allow()`` answers "may a dispatch go to this replica now":
    closed -> yes; open -> no until the cooldown elapses, then the
    transition to half-open admits EXACTLY ONE probe (further
    ``allow()`` calls say no while the probe is in flight);
    ``ok()`` closes from any state, ``fail()`` counts toward the
    threshold and re-opens immediately from half-open."""

    def __init__(self, threshold=None, cooldown=None):
        self.threshold = (get_env("MXTPU_BREAKER_THRESHOLD")
                          if threshold is None else int(threshold))
        self.cooldown = (get_env("MXTPU_BREAKER_COOLDOWN")
                         if cooldown is None else float(cooldown))
        self.state = "closed"
        self.failures = 0
        self.open_until = 0.0
        self.probe_rid = None

    def allow(self, now):
        if self.state == "closed":
            return True
        if self.state == "open":
            if now >= self.open_until:
                self.state = "half_open"
                self.probe_rid = None    # set by the dispatch path
                return True
            return False
        # half_open: one probe slot — free until the dispatch path
        # stamps probe_rid, then taken until the probe resolves
        return self.probe_rid is None

    def ok(self):
        self.state = "closed"
        self.failures = 0
        self.probe_rid = None

    def fail(self, now):
        self.failures += 1
        tripped = (self.state == "half_open"
                   or self.failures >= self.threshold)
        if tripped and self.state != "open":
            self.state = "open"
            self.open_until = now + self.cooldown
            self.probe_rid = None
            return True              # newly opened
        if self.state == "open":
            self.open_until = now + self.cooldown
        return False


class _ReplicaLink:
    """One replica: RPC client + reader thread + health state."""

    def __init__(self, name, host, port, router):
        self.name = name
        self.client = rpc.RpcClient(host, port)
        self.router = router
        self.breaker = _Breaker(router.breaker_threshold,
                                router.breaker_cooldown)
        self.inflight = set()       # rids currently owned here
        self.last_heard = 0.0       # monotonic, any frame refreshes
        self.ewma_latency = 0.0     # seconds, from ping RTT
        self.alive = False
        self.drained = False
        self._reader = None
        self._reconnecting = False
        self._pings = {}            # seq -> send ts
        self._ping_seq = 0

    def usable(self, now):
        """May a dispatch be sent here right now (connection up,
        heartbeat fresh, breaker consenting)?"""
        return (self.alive
                and now - self.last_heard <= self.router.stale_after
                and self.breaker.allow(now))

    def healthy(self, now):
        """Health for reporting: up + fresh (breaker state aside)."""
        return (self.alive
                and now - self.last_heard <= self.router.stale_after)

    def connect(self, retry=True):
        if retry:
            self.client.connect_retry()
        else:
            # deadline-ok: RpcClient.connect arms its own per-call
            # connect timeout (rpc.default_timeout)
            self.client.connect()
        self.alive = True
        self.drained = False
        self.last_heard = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"router-read-{self.name}")
        self._reader.start()

    def _read_loop(self):
        me = threading.current_thread()
        while self.alive and self._reader is me:
            try:
                msg, budget = self.client.recv(
                    timeout=self.router.poll_interval)
            except rpc.RpcTimeoutError:
                continue             # idle tick; staleness is poll()'s call
            except rpc.RpcError:
                if self.alive and self._reader is me:
                    self.router._on_link_down(self, "link lost")
                return
            self.last_heard = time.monotonic()
            self.router._on_frame(self, msg, budget)

    def send(self, msg, budget=0.0):
        self.client.send(msg, budget=budget)

    def ping(self):
        self._ping_seq += 1
        seq = self._ping_seq
        self._pings[seq] = time.monotonic()
        try:
            self.send({"op": "ping", "seq": seq})
        except rpc.RpcError:
            self.router._on_link_down(self, "ping send failed")

    def observe_pong(self, seq):
        sent = self._pings.pop(seq, None)
        if sent is not None:
            rtt = time.monotonic() - sent
            self.ewma_latency = (0.8 * self.ewma_latency
                                 + 0.2 * rtt
                                 if self.ewma_latency else rtt)

    def close(self):
        self.alive = False
        self._reader = None
        self.client.close()


class ServingRouter:
    """Route requests over a replica fleet (see module doc).

    ``replicas`` is a list of ``"host:port"`` strings or
    ``(host, port)`` pairs (default: ``MXTPU_REPLICA_ADDRS``).  The
    router is driven by :meth:`poll` — call it from your serve loop,
    or let :meth:`listen`'s background poller do it."""

    def __init__(self, replicas=None, queue_limit=None,
                 queue_tokens=None, block_size=None,
                 breaker_threshold=None, breaker_cooldown=None,
                 ttft_deadline=None, deadline=None,
                 poll_interval=0.05, stale_after=None,
                 ping_interval=None, expiry_grace=0.5):
        if replicas is None:
            raw = get_env("MXTPU_REPLICA_ADDRS")
            replicas = [a for a in raw.split(",") if a.strip()]
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.queue_limit = (get_env("MXTPU_SERVE_QUEUE_LIMIT")
                            if queue_limit is None else queue_limit)
        self.queue_tokens = (get_env("MXTPU_SERVE_QUEUE_TOKENS")
                             if queue_tokens is None
                             else queue_tokens)
        self.block_size = (get_env("MXTPU_SERVE_BLOCK_SIZE")
                           if block_size is None else block_size)
        self.ttft_deadline = (get_env("MXTPU_SERVE_TTFT_DEADLINE")
                              if ttft_deadline is None
                              else ttft_deadline)
        self.deadline = (get_env("MXTPU_SERVE_DEADLINE")
                         if deadline is None else deadline)
        self.poll_interval = poll_interval
        self.stale_after = (3.0 * rpc.default_timeout()
                            if stale_after is None else stale_after)
        self.ping_interval = (max(poll_interval * 4, 0.2)
                              if ping_interval is None
                              else ping_interval)
        self.expiry_grace = expiry_grace
        self._lock = threading.RLock()
        self._links = {}
        for i, spec in enumerate(replicas):
            if isinstance(spec, (tuple, list)):
                host, port = spec
            else:
                host, _, port = str(spec).rpartition(":")
            name = f"replica{i}"
            self._links[name] = _ReplicaLink(name, host or
                                             "127.0.0.1",
                                             int(port), self)
        self._live = {}             # rid -> FleetRequest (not terminal)
        self._terminal_ids = set()  # exactly-one-terminal dedup
        self._pending = []          # admitted, awaiting a healthy link
        self._affinity = {}         # chain hash -> link name (FIFO cap)
        self._next_id = 0
        self._draining = False       # admission gate
        self._drain_started = False  # drain frames sent to replicas
        self._drain_requested = False
        self._drained_links = set()
        self._last_ping = 0.0
        self._last_stats = None
        self._frontend = None
        self._poller = None
        self._closed = threading.Event()
        self.snapshot_dir = None    # per-replica drain snapshots

    # ------------------------------------------------------ lifecycle
    def connect(self):
        """Connect every link (full-jitter retries); returns self."""
        for link in self._links.values():
            try:
                # deadline-ok: bounded internally (connect_retry's
                # jittered attempts each arm a connect timeout)
                link.connect()
            except rpc.RpcError as e:
                logger.warning("router: %s unreachable at startup: "
                               "%s", link.name, e)
        self._update_health_gauge()
        return self

    def close(self):
        self._closed.set()
        if self._frontend is not None:
            self._frontend.close()
        for link in self._links.values():
            link.close()
        if self._poller is not None:
            self._poller.join(timeout=2.0)

    # ------------------------------------------------------ admission
    def _reject(self, reason, n_tokens):
        _m_rejected.inc()
        tracing.trace_event("router_reject", reason=reason,
                            n_tokens=n_tokens)
        raise ServeRejectedError(
            f"fleet admission rejected request ({reason}); "
            "retry later or scale the fleet")

    def submit(self, tokens, max_new_tokens, eos_id=None,
               ttft_deadline=None, deadline=None):
        """Admit one request fleet-wide; returns a
        :class:`FleetRequest` whose ``done_event`` fires at its
        single terminal state.  Raises :class:`ServeRejectedError`
        exactly like ``ServingEngine.submit`` when draining or over
        the fleet queue/token budgets."""
        tokens = [int(t) for t in tokens]
        with self._lock:
            if self._draining:
                self._reject("draining", len(tokens))
            if self.queue_limit and len(self._live) >= \
                    self.queue_limit:
                self._reject("queue_limit", len(tokens))
            if self.queue_tokens:
                queued = sum(len(r.prompt)
                             for r in self._live.values())
                if queued + len(tokens) > self.queue_tokens:
                    self._reject("queue_tokens", len(tokens))
            rid = self._next_id
            self._next_id += 1
            req = FleetRequest(rid, tokens, max_new_tokens,
                               eos_id=eos_id)
            now = time.monotonic()
            ttft = (self.ttft_deadline if ttft_deadline is None
                    else ttft_deadline)
            total = self.deadline if deadline is None else deadline
            if ttft:
                req.ttft_deadline_ts = now + ttft
            if total:
                req.deadline_ts = now + total
            self._live[rid] = req
            _m_requests.inc()
            self._dispatch(req)
        return req

    def cancel(self, rid):
        """Propagate cancellation; the owning replica's cancel
        terminal (or the deadline net) finalizes the request."""
        with self._lock:
            req = self._live.get(rid)
            if req is None or req.done:
                return False
            link = self._links.get(req.link)
        if link is not None and link.alive:
            try:
                link.send({"op": "cancel", "rid": rid})
            except rpc.RpcError:
                pass
        return True

    # -------------------------------------------------------- routing
    def _chain_keys(self, tokens):
        """The prompt's full-block chain hashes, shortest prefix
        first — the same rolling hash PrefixCache builds, so "the
        replica that served this chain" is exactly "the replica
        whose cache likely holds these blocks"."""
        bs = self.block_size
        keys, key = [], _SEED
        for b in range((len(tokens) - 1) // bs):
            key = hash((key,) + tuple(tokens[b * bs:(b + 1) * bs]))
            keys.append(key)
        return keys

    def _pick(self, req, exclude=()):
        """Choose a usable link: longest prefix-affinity match
        first, else least-queued (EWMA latency as tiebreak)."""
        now = time.monotonic()
        usable = {n: l for n, l in self._links.items()
                  if n not in exclude and l.usable(now)}
        if not usable:
            return None
        keys = self._chain_keys(req.prompt)
        for key in reversed(keys):
            name = self._affinity.get(key)
            if name in usable:
                return usable[name]
        return min(usable.values(),
                   key=lambda l: (len(l.inflight), l.ewma_latency))

    def _remember_affinity(self, req, link):
        for key in self._chain_keys(req.prompt):
            self._affinity[key] = link.name
        while len(self._affinity) > _AFFINITY_CAP:
            self._affinity.pop(next(iter(self._affinity)))

    def _entry_for(self, req, now):
        """The submit frame body: snapshot-entry schema (the same
        one ``ServingEngine.resubmit`` consumes) with deadlines as
        REMAINING seconds."""
        return {"op": "submit", "rid": req.id, "gen": req.gen,
                "prompt": req.prompt,
                "generated": list(req.generated),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "ttft_done": req.ttft_done,
                "ttft_remaining_s": (
                    req.ttft_deadline_ts - now
                    if req.ttft_deadline_ts is not None
                    and not req.ttft_done else None),
                "deadline_remaining_s": (
                    req.deadline_ts - now
                    if req.deadline_ts is not None else None)}

    def _dispatch(self, req, exclude=()):
        """Send ``req`` to a usable replica (lock held).  No usable
        replica parks it on the pending list — poll() retries until
        a link heals or the deadline net expires it; an admitted
        request is never silently dropped."""
        link = self._pick(req, exclude=exclude)
        if link is None:
            if req not in self._pending:
                self._pending.append(req)
            return False
        now = time.monotonic()
        req.link = link.name
        link.inflight.add(req.id)
        if link.breaker.state == "half_open" \
                and link.breaker.probe_rid is None:
            link.breaker.probe_rid = req.id
            tracing.trace_event("router_breaker", replica=link.name,
                                state="half_open", rid=req.id)
        budget = (req.deadline_ts - now
                  if req.deadline_ts is not None else 0.0)
        try:
            link.send(self._entry_for(req, now),
                      budget=max(budget, 0.0))
        except rpc.RpcError as e:
            link.inflight.discard(req.id)
            self._fail_link_dispatch(link, f"dispatch send: {e}")
            return self._dispatch(req, exclude=tuple(exclude)
                                  + (link.name,))
        event = ("router_redispatch" if req.redispatches
                 else "router_dispatch")
        tracing.trace_event(event, rid=req.id, replica=link.name,
                            gen=req.gen,
                            generated=len(req.generated))
        self._remember_affinity(req, link)
        return True

    # ------------------------------------------------ failure handling
    def _fail_link_dispatch(self, link, why):
        """Count one dispatch failure against a link's breaker."""
        now = time.monotonic()
        _m_rep_fail.inc()
        if link.breaker.fail(now):
            _m_breaker_open.inc()
            tracing.trace_event("router_breaker", replica=link.name,
                                state="open", why=why)
        logger.warning("router: %s dispatch failure: %s", link.name,
                       why)

    def _on_link_down(self, link, why):
        """A replica stopped answering (reader EOF, frame
        corruption, failed send, staleness): re-dispatch everything
        it owned to survivors with remaining budgets, then let the
        background reconnect try to bring it back."""
        with self._lock:
            if not link.alive:
                return
            link.alive = False
            link.client.close()
            down_ts = time.monotonic()
            owned = [self._live[rid] for rid in list(link.inflight)
                     if rid in self._live]
            link.inflight.clear()
            self._fail_link_dispatch(link, why)
            tracing.trace_event("router_replica_down",
                                replica=link.name, why=why,
                                inflight=len(owned))
            for req in owned:
                if req.done:
                    continue
                req.gen += 1
                req.redispatches += 1
                req._redispatch_ts = down_ts
                _m_redispatch.inc()
                self._dispatch(req, exclude=(link.name,))
            self._update_health_gauge()
        if not self._draining:
            self._start_reconnect(link)

    def _start_reconnect(self, link):
        with self._lock:
            if link._reconnecting or self._closed.is_set():
                return
            link._reconnecting = True

        def _reconnect():
            try:
                # full jitter: N links re-homing after the same blip
                # must not retry in lockstep
                # deadline-ok: each jittered attempt arms a bounded
                # connect timeout (RpcClient.connect)
                link.connect(retry=True)
                logger.info("router: %s reconnected", link.name)
            except rpc.RpcError as e:
                logger.warning("router: %s reconnect failed: %s",
                               link.name, e)
            finally:
                link._reconnecting = False
                self._update_health_gauge()

        threading.Thread(target=_reconnect, daemon=True,
                         name=f"router-reconnect-{link.name}"
                         ).start()

    # ------------------------------------------------- frame handling
    def _on_frame(self, link, msg, budget):
        op = msg.get("op")
        if op == "pong":
            link.observe_pong(msg.get("seq"))
            return
        if op == "drained":
            with self._lock:
                link.drained = True
                self._drained_links.add(link.name)
            return
        if op == "stats":
            with self._lock:
                self._last_stats = msg
            return
        rid = msg.get("rid")
        if rid is None:
            return
        with self._lock:
            req = self._live.get(rid)
            if req is None or req.done:
                return                       # dup guard: already terminal
            if msg.get("gen", 0) != req.gen or \
                    req.link != link.name:
                return                       # stale dispatch generation
            if op == "token":
                tok = int(msg["tok"])
                req.generated.append(tok)
                if not req.ttft_done:
                    req.ttft_done = True
                    req.first_token_ts = time.monotonic()
                if req._redispatch_ts is not None:
                    _m_failover.observe(time.monotonic()
                                        - req._redispatch_ts)
                    req._redispatch_ts = None
                if link.breaker.probe_rid == rid:
                    link.breaker.ok()
                    tracing.trace_event("router_breaker",
                                        replica=link.name,
                                        state="closed", rid=rid)
                sink = req.sink
            elif op == "terminal":
                if link.breaker.probe_rid == rid:
                    link.breaker.ok()
                    tracing.trace_event("router_breaker",
                                        replica=link.name,
                                        state="closed", rid=rid)
                self._finalize(req, msg.get("state", FAILED),
                               tokens=msg.get("tokens"),
                               error=msg.get("error"), link=link)
                return
            elif op == "nack":
                probe_failed = link.breaker.probe_rid == rid
                link.inflight.discard(rid)
                self._fail_link_dispatch(
                    link, f"nack: {msg.get('error')}")
                if probe_failed:
                    tracing.trace_event("router_breaker",
                                        replica=link.name,
                                        state="reopened", rid=rid)
                if msg.get("fatal"):
                    self._finalize(req, FAILED,
                                   error=msg.get("error"),
                                   link=link)
                else:
                    req.gen += 1
                    req.redispatches += 1
                    _m_redispatch.inc()
                    self._dispatch(req, exclude=(link.name,))
                return
            else:
                return
        # token streaming to a front-door client happens outside the
        # lock (socket sends must not serialize the router)
        if op == "token" and sink is not None and not sink.closed:
            try:
                sink.send({"op": "token", "rid": rid, "tok": tok})
            except rpc.RpcError:
                pass

    def _finalize(self, req, state, tokens=None, error=None,
                  link=None):
        """The router's single terminal point: first caller wins,
        every other source of a terminal for this request is
        dropped at the ``req.done`` / ``_terminal_ids`` guard."""
        with self._lock:
            if req.done or req.id in self._terminal_ids:
                return False
            if state not in TERMINAL_STATES:
                state = FAILED
            if tokens is not None:
                req.generated = [int(t) for t in tokens]
            req.state = state
            req.error = error
            self._terminal_ids.add(req.id)
            self._live.pop(req.id, None)
            if req in self._pending:
                self._pending.remove(req)
            owner = self._links.get(req.link)
            if owner is not None:
                owner.inflight.discard(req.id)
            sink = req.sink
        tracing.trace_event("router_terminal", rid=req.id,
                            replica=req.link, state=state,
                            redispatches=req.redispatches)
        req.done_event.set()
        if sink is not None and not sink.closed:
            try:
                sink.send({"op": "terminal", "rid": req.id,
                           "state": state, "error": error,
                           "tokens": list(req.generated)})
            except rpc.RpcError:
                pass
        return True

    # ------------------------------------------------------ health
    def _update_health_gauge(self):
        now = time.monotonic()
        _m_healthy.set(sum(1 for l in self._links.values()
                           if l.healthy(now)))

    def poll(self):
        """One health tick: ping links, detect staleness, retry
        parked requests, run the deadline net, execute a
        signal-requested drain.  Call it from your serve loop (or
        rely on :meth:`listen`'s poller)."""
        now = time.monotonic()
        if self._drain_requested:
            self._drain_requested = False
            self.drain(wait=False)
        if now - self._last_ping >= self.ping_interval:
            self._last_ping = now
            for link in self._links.values():
                if link.alive:
                    link.ping()
        for link in list(self._links.values()):
            if link.alive and \
                    now - link.last_heard > self.stale_after:
                self._on_link_down(link, "heartbeat stale")
            elif not link.alive and not self._draining:
                # a link that is down — or was never reachable at
                # startup (replica still booting) — keeps getting
                # background reconnect attempts; _start_reconnect
                # dedups concurrent ones
                self._start_reconnect(link)
        with self._lock:
            pending, self._pending = self._pending, []
            for req in pending:
                if not req.done:
                    self._dispatch(req)
            # deadline net: a request past its total deadline whose
            # owner never delivered a terminal (wedged replica,
            # injected hang) expires HERE — exactly-one-terminal
            # must not depend on every replica behaving
            expired = [r for r in self._live.values()
                       if not r.done and r.deadline_ts is not None
                       and now > r.deadline_ts + self.expiry_grace]
        for req in expired:
            self._finalize(req, EXPIRED,
                           error="deadline exceeded (router net)")
        self._update_health_gauge()

    # -------------------------------------------------------- waiting
    def wait(self, reqs=None, timeout=30.0):
        """Drive :meth:`poll` until every request (default: all
        live) is terminal; returns True when they all are."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                targets = (list(self._live.values())
                           if reqs is None else reqs)
                if all(r.done for r in targets):
                    return True
            self.poll()
            time.sleep(self.poll_interval)
        with self._lock:
            targets = (list(self._live.values())
                       if reqs is None else reqs)
            return all(r.done for r in targets)

    # ---------------------------------------------------------- drain
    def drain(self, wait=True, timeout=None, snapshot_dir=None):
        """Stop admission and drain the fleet: every replica
        snapshots its in-flight requests (restorable via
        ``ServingEngine.restore``) and finishes its running batch.
        Returns the set of replicas that confirmed ``drained``."""
        with self._lock:
            # _draining only gates admission (the SIGTERM handler
            # sets it from the signal frame to shut the door
            # immediately); _drain_started tracks whether the drain
            # frames went out, so the latched drain still sends them
            first = not self._drain_started
            self._drain_started = True
            self._draining = True
            if snapshot_dir is not None:
                self.snapshot_dir = snapshot_dir
        if first:
            tracing.trace_event("router_drain",
                                replicas=len(self._links))
            for link in self._links.values():
                if not link.alive:
                    continue
                snap = None
                if self.snapshot_dir:
                    snap = os.path.join(self.snapshot_dir,
                                        f"{link.name}.snap")
                try:
                    link.send({"op": "drain", "snapshot": snap})
                except rpc.RpcError:
                    pass
        if wait:
            t = rpc.default_timeout() if timeout is None else timeout
            deadline = time.monotonic() + t
            while time.monotonic() < deadline:
                with self._lock:
                    alive = {n for n, l in self._links.items()
                             if l.alive}
                    if alive <= self._drained_links:
                        break
                time.sleep(self.poll_interval)
        with self._lock:
            return set(self._drained_links)

    def install_sigterm(self, snapshot_dir=None):
        """SIGTERM -> fleet drain.  The handler only *latches* the
        request (socket work from a signal frame is asking for
        re-entrancy trouble); the next :meth:`poll` performs the
        drain.  Main-thread only; returns False when it cannot
        install."""
        import signal as _signal
        if threading.current_thread() is not \
                threading.main_thread():
            return False
        if snapshot_dir is not None:
            self.snapshot_dir = snapshot_dir
        prev = _signal.getsignal(_signal.SIGTERM)

        def _handler(signum, frame):
            self._drain_requested = True
            self._draining = True
            if callable(prev):
                prev(signum, frame)

        _signal.signal(_signal.SIGTERM, _handler)
        return True

    def replica_stats(self, name, timeout=5.0):
        """Ask one replica for its engine stats + block-pool audit
        (the per-replica ``BlockPool.live()`` leak check)."""
        link = self._links[name]
        with self._lock:
            self._last_stats = None
        link.send({"op": "stats"})
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                s = self._last_stats
            if s is not None and s.get("replica"):
                return s
            time.sleep(0.01)
        raise rpc.RpcTimeoutError(
            f"replica {name} stats did not arrive in {timeout}s")

    # ---------------------------------------------------------- stats
    def stats(self):
        now = time.monotonic()
        with self._lock:
            return {
                "live": len(self._live),
                "pending": len(self._pending),
                "terminals": len(self._terminal_ids),
                "draining": self._draining,
                "replicas": {
                    n: {"alive": l.alive,
                        "healthy": l.healthy(now),
                        "inflight": len(l.inflight),
                        "breaker": l.breaker.state,
                        "ewma_latency_s": l.ewma_latency,
                        "drained": l.drained}
                    for n, l in self._links.items()},
            }

    # ----------------------------------------------------- front door
    def listen(self, host="127.0.0.1", port=None,
               poll_in_background=True):
        """Expose the router over the same frame protocol clients of
        a single replica would speak (``MXTPU_ROUTER_PORT``):
        ``submit`` admits (reply ``ack`` or ``reject``) and streams
        ``token``/``terminal`` frames back on the submitting
        connection; ``cancel``, ``stats``, ``ping`` and ``drain``
        map to the same-named methods.  Returns the bound port."""
        if port is None:
            port = get_env("MXTPU_ROUTER_PORT")

        def _handler(msg, conn, budget):
            op = msg.get("op")
            if op == "ping":
                return {"op": "pong", "seq": msg.get("seq")}
            if op == "stats":
                return {"op": "stats", "stats": self.stats()}
            if op == "cancel":
                self.cancel(int(msg["rid"]))
                return None
            if op == "drain":
                self.drain(wait=False)
                return {"op": "draining"}
            if op == "submit":
                try:
                    req = self.submit(
                        msg["prompt"], msg["max_new_tokens"],
                        eos_id=msg.get("eos_id"),
                        ttft_deadline=msg.get("ttft_deadline"),
                        deadline=(budget if budget and budget > 0
                                  else msg.get("deadline")))
                except ServeRejectedError as e:
                    return {"op": "reject", "error": str(e)}
                req.sink = conn
                return {"op": "ack", "rid": req.id}
            return {"op": "error", "error": f"unknown op {op!r}"}

        self._frontend = rpc.RpcServer(_handler, host=host,
                                       port=port,
                                       name="router-frontend")
        self._frontend.start()
        # live introspection: router statusz mirrors the stats op
        # (same host-side snapshot, no request-path involvement)
        debugz.maybe_start("router")
        debugz.register_provider("router", self.stats)
        if poll_in_background:
            def _poll_loop():
                while not self._closed.is_set():
                    self.poll()
                    time.sleep(self.poll_interval)

            self._poller = threading.Thread(
                target=_poll_loop, daemon=True,
                name="router-poller")
            self._poller.start()
        return self._frontend.port
