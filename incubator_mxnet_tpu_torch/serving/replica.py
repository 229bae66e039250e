"""Fleet replica: one :class:`ServingEngine` behind the RPC server (twin
of ``incubator_mxnet_tpu/serving/replica.py``; the frames are the JAX
package's, so either package's router drives either package's replica).

A replica is a worker process the router dispatches requests to over
``serving/rpc.py`` frames.  It speaks launch.py's heartbeat files
(``resilience.start_heartbeat``), honors SIGTERM as
snapshot-then-drain (``ServingEngine.install_sigterm``), and streams
every token plus exactly one terminal status frame back per request
id.  Protocol (all frames JSON dicts with an ``op`` field):

router -> replica
    ``submit``   one request in ``_snapshot_request`` entry form plus
                 ``rid`` (the fleet-wide id — used as the engine id)
                 and ``gen`` (dispatch generation for dedup)
    ``cancel``   cancel ``rid``
    ``drain``    snapshot (to ``snapshot`` path or the configured
                 one), latch drain, reply ``drained`` once the
                 running batch finishes
    ``stats``    reply with engine stats, the per-replica
                 ``BlockPool.live()`` audit beside the prefix cache's
                 block references (``cache_refs``), and the
                 device-memory counters (``tracing.device_memory_stats``:
                 allocator metadata, no device read)
    ``ping``     liveness probe, replied to on the RPC reader thread
                 (stays responsive while the engine loop works, and
                 touches no CUDA state)

replica -> router
    ``token``     one generated token for ``rid`` (tagged ``gen``)
    ``terminal``  the request's single terminal state, with the full
                  generated token list (authoritative for dedup)
    ``nack``      a dispatch this replica could not accept
                  (``fatal`` tells the router whether to re-route or
                  fail the request)

Dispatch generations make re-dispatch safe: the router bumps ``gen``
each time it re-homes a request, and both sides drop frames from a
stale generation — a request re-dispatched *back* to this replica
after a network blip cancels the old engine copy first and defers
the resubmit until that copy's (swallowed) terminal confirms its
blocks are free, so exactly one copy ever decodes.

Deterministic fault injection: each inbound dispatch consults
``router:replica`` (``MXTPU_FAULT_SPEC``) — ``kill`` hard-exits the
process (the failover test vector), ``hang`` wedges the serve loop
(the router's deadline net catches it), ``error`` nacks the dispatch
(a breaker failure without process death).
"""
import argparse
import os
import sys
import threading
import time
from collections import deque

from .. import debugz, resilience, telemetry, tracing
from ..utils.env import get_env
from ..utils.log import get_logger
from . import rpc
from .engine import ServingEngine
from .scheduler import RequestTooLargeError

logger = get_logger("serving.replica")

_m_dispatches = telemetry.counter("fleet_dispatches_total")
_m_terminals = telemetry.counter("fleet_terminals_total")
_m_nacks = telemetry.counter("fleet_nacks_total")


class ReplicaServer:
    """Wrap one engine behind the frame protocol (see module doc).  The
    engine runs on ``model``'s device."""

    def __init__(self, model=None, engine=None, name=None,
                 host="127.0.0.1", port=None, snapshot_path=None,
                 poll=0.002, **engine_kw):
        if engine is None:
            engine = ServingEngine(model, **engine_kw)
        self.eng = engine
        self.name = name or f"replica-{os.getpid()}"
        self.snapshot_path = snapshot_path
        self._poll = poll
        self._inbox = deque()       # (msg, conn) pairs, reader -> loop
        self._router = None         # conn terminals/tokens stream to
        self._stop = threading.Event()
        self._gen = {}              # fleet rid -> current dispatch gen
        self._stale = set()         # rids whose engine copy is superseded
        self._deferred = {}         # rid -> submit msg awaiting old copy
        if port is None:
            port = get_env("MXTPU_REPLICA_PORT")
        self._srv = rpc.RpcServer(self._on_frame, host=host,
                                  port=port, name=self.name)

    @property
    def port(self):
        return self._srv.port

    # ------------------------------------------------ RPC reader side
    def _on_frame(self, msg, conn, budget):
        op = msg.get("op")
        if op in ("submit", "cancel", "drain"):
            # only command frames claim the streaming conn: a stats
            # probe from a side channel must not steal the router's
            # token stream
            self._router = conn
        if op == "ping":
            # replied inline on the reader thread: liveness must not
            # queue behind engine work (host counters only)
            return {"op": "pong", "seq": msg.get("seq"),
                    "replica": self.name,
                    "queue_depth": len(self.eng._sched.waiting),
                    "running": self.eng._sched.n_running()}
        self._inbox.append((msg, conn, budget))
        return None

    # ------------------------------------------------ serve-loop side
    def _send(self, msg, budget=0.0):
        """Best-effort stream to the router: a dead link drops the
        frame (the router re-dispatches everything this replica owned
        once it notices — state lives above the transport)."""
        conn = self._router
        if conn is None or conn.closed:
            return False
        try:
            conn.send(msg, budget=budget)
            return True
        except rpc.RpcError:
            return False

    def _handle_submit(self, msg, conn, budget):
        rid = int(msg["rid"])
        gen = int(msg.get("gen", 0))
        self._gen[rid] = gen
        try:
            resilience.inject("router", "replica")
        except resilience.TransientError as e:
            _m_nacks.inc()
            self._send({"op": "nack", "rid": rid, "gen": gen,
                        "replica": self.name, "error": str(e),
                        "fatal": False})
            return
        live = self.eng._live.get(rid)
        if live is not None and not live.done:
            # the same fleet request re-dispatched back here (net
            # blip): cancel the old engine copy and defer this submit
            # until its swallowed terminal frees its blocks — exactly
            # one copy may decode
            self._stale.add(rid)
            self._deferred[rid] = msg
            self.eng.cancel(rid)
            return
        self._stale.discard(rid)
        entry = {"id": rid, "prompt": msg["prompt"],
                 "generated": msg.get("generated", []),
                 "max_new_tokens": msg["max_new_tokens"],
                 "eos_id": msg.get("eos_id"),
                 "ttft_done": msg.get("ttft_done", False),
                 "ttft_remaining_s": msg.get("ttft_remaining_s"),
                 "deadline_remaining_s": (
                     budget if budget and budget > 0
                     else msg.get("deadline_remaining_s")),
                 "preemptions": int(msg.get("preemptions", 0))}
        try:
            req = self.eng.resubmit(
                entry, redispatch=bool(msg.get("generated")))
        except RequestTooLargeError as e:
            _m_nacks.inc()
            self._send({"op": "nack", "rid": rid, "gen": gen,
                        "replica": self.name, "error": str(e),
                        "fatal": True})
            return
        _m_dispatches.inc()
        tracing.trace_event("fleet_dispatch", rid=rid,
                            replica=self.name, gen=gen,
                            generated=len(req.generated))

    def _stats_reply(self):
        """Host bookkeeping only: engine stats, the block-pool audit
        (with the prefix cache's own references, which a pool with the
        cache on keeps after its requests end), and the allocator's
        counters (metadata, never a device read)."""
        return {"op": "stats", "replica": self.name,
                "stats": self.eng.stats(),
                "pool_live": {str(k): v for k, v in
                              self.eng.pool.live().items()},
                "cache_refs": {str(k): v for k, v in
                               self.eng.cache.block_refs().items()},
                "num_allocated": self.eng.pool.num_allocated,
                "memory": tracing.device_memory_stats()}

    def _handle(self, msg, conn, budget):
        op = msg.get("op")
        if op == "submit":
            self._handle_submit(msg, conn, budget)
        elif op == "cancel":
            self.eng.cancel(int(msg["rid"]))
        elif op == "drain":
            path = msg.get("snapshot") or self.snapshot_path
            if path:
                self.eng.snapshot(path)
            self.eng._latch_drain()
        elif op == "stats":
            try:
                conn.send(self._stats_reply())
            except rpc.RpcError:
                pass
        else:
            logger.warning("%s: unknown op %r dropped", self.name, op)

    def _forward_terminal(self, req):
        rid = req.id
        if rid in self._stale:
            # superseded copy: swallow its terminal (the fleet-wide
            # terminal belongs to the live dispatch) and admit any
            # deferred resubmit now that its blocks are free
            self._stale.discard(rid)
            deferred = self._deferred.pop(rid, None)
            if deferred is not None:
                self._handle_submit(deferred, self._router, 0.0)
            return
        gen = self._gen.pop(rid, 0)
        _m_terminals.inc()
        tracing.trace_event("fleet_terminal", rid=rid,
                            replica=self.name, gen=gen,
                            state=req.state)
        self._send({"op": "terminal", "rid": rid, "gen": gen,
                    "replica": self.name, "state": req.state,
                    "error": (str(req.error)
                              if req.error is not None else None),
                    "tokens": [int(t) for t in req.generated]})

    def serve_forever(self):
        """Run until drained (SIGTERM or a ``drain`` frame) or
        :meth:`stop`.  Installs the SIGTERM snapshot-then-drain hook
        when a snapshot path is configured (main thread only — a loop
        driven from elsewhere keeps the previous disposition)."""
        resilience.start_heartbeat()
        if self.snapshot_path:
            self.eng.install_sigterm(self.snapshot_path, drain=True)
        self._srv.start()
        eng = self.eng
        # live introspection: statusz serves engine stats and scheduler
        # depth (host-side counters only — no step-loop interference)
        debugz.maybe_start("replica")
        unregister = debugz.register_provider(
            "engine", lambda: {
                "name": self.name,
                "stats": eng.stats(),
                "queue_depth": len(eng._sched.waiting),
                "running": eng._sched.n_running(),
                "draining": eng._draining,
            })
        try:
            while not self._stop.is_set():
                busy = False
                while self._inbox:
                    self._handle(*self._inbox.popleft())
                    busy = True
                if eng.has_work():
                    for req, tok in eng.step():
                        rid = req.id
                        if rid in self._stale:
                            continue
                        self._send({"op": "token", "rid": rid,
                                    "gen": self._gen.get(rid, 0),
                                    "replica": self.name,
                                    "tok": int(tok)})
                    busy = True
                for req in eng.take_completed():
                    self._forward_terminal(req)
                    busy = True
                if eng._draining and not eng.has_work() \
                        and not self._inbox:
                    self._send({"op": "drained",
                                "replica": self.name,
                                "snapshot": self.snapshot_path})
                    break
                if not busy:
                    time.sleep(self._poll)
        finally:
            unregister()
            self._srv.close()
            resilience.stop_heartbeat()

    def stop(self):
        self._stop.set()

    def close(self):
        self.stop()
        self._srv.close()


def _build_tiny(spec, *, device=None):
    """Deterministic TransformerLM for fleet tests and chip runs, on
    ``device`` (None: the default context, which is the card unless
    ``MXTPU_FORCE_CPU`` pins the host).  ``random.seed(0)`` plus Xavier
    gives every process that builds the same spec bit-identical weights,
    on any device: the port's initializers draw from the CPU generator
    and copy the draw onto the parameter's device.  That is what makes a
    re-dispatched request's output token-identical across replicas."""
    from .. import initializer, random
    from ..gluon.model_zoo.transformer import TransformerLM
    from ..utils.platform import maybe_force_cpu
    if device is None:
        maybe_force_cpu()       # MXTPU_FORCE_CPU=1 builds on the host
    kw = {"vocab": 37, "d_model": 32, "n_layers": 2, "n_heads": 4,
          "max_len": 64}
    for part in (spec or "").split(","):
        part = part.strip()
        if part:
            k, v = part.split("=")
            kw[k.strip()] = int(v)
    random.seed(0)
    net = TransformerLM(kw["vocab"], d_model=kw["d_model"],
                        n_layers=kw["n_layers"], n_heads=kw["n_heads"],
                        max_len=kw["max_len"], device=device)
    initializer.initialize(net, initializer.Xavier())
    return net


def main(argv=None):
    """CLI entry: ``python -m incubator_mxnet_tpu_torch.serving.replica``.
    Builds the deterministic model (``--tiny``), optionally restores a
    drain snapshot, and serves until drained."""
    ap = argparse.ArgumentParser(prog="serving.replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    ap.add_argument("--name", default=None)
    ap.add_argument("--tiny", default="",
                    help="tiny-model spec, e.g. 'vocab=37,d_model=32'")
    ap.add_argument("--snapshot", default=None,
                    help="SIGTERM/drain snapshot path")
    ap.add_argument("--restore", default=None,
                    help="restore this snapshot at boot")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefix-cache", type=int, default=None)
    args = ap.parse_args(argv)
    net = _build_tiny(args.tiny)
    eng_kw = {}
    for key in ("max_batch", "block_size", "num_blocks"):
        if getattr(args, key) is not None:
            eng_kw[key] = getattr(args, key)
    if args.prefix_cache is not None:
        eng_kw["prefix_cache"] = bool(args.prefix_cache)
    if args.restore and os.path.exists(args.restore):
        engine = ServingEngine.restore(net, args.restore, **eng_kw)
        srv = ReplicaServer(engine=engine, name=args.name,
                            host=args.host, port=args.port,
                            snapshot_path=args.snapshot)
    else:
        srv = ReplicaServer(net, name=args.name, host=args.host,
                            port=args.port,
                            snapshot_path=args.snapshot, **eng_kw)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(srv.port))
        os.replace(tmp, args.port_file)
    logger.info("%s listening on %s:%d", srv.name, args.host, srv.port)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
