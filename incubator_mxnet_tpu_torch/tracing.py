"""Flight recorder: per-request traces, retrace attribution, and
device-memory accounting (twin of ``incubator_mxnet_tpu/tracing.py``;
docs/observability.md).

The telemetry registry (telemetry.py) answers *how much*; this layer
answers *which one and why*: a bounded, lock-cheap ring buffer of
structured events plus three producer families:

- **Pipeline and fault events**: the data service's worker deaths,
  restarts, failovers and reshards, the iterators' quarantines, and
  the fault dumps ``DataPipelineError`` triggers.
- **Retrace attribution** (:func:`compile_ledger`): where the JAX
  package records a compile, the port records a *capture* (a
  ``StepGraph`` capture of a train step, a ``CachedOp`` trace) under
  the same site names, with its wall-clock time and a **signature
  diff vs the nearest cached entry**.  ``MXTPU_COMPILE_BUDGET`` arms
  the same retrace-storm watchdog.
- **Device-memory accounting** (:func:`update_memory_gauges`):
  live and peak bytes from ``torch.cuda.memory_stats()``, attributed
  to params / optimizer state / KV pools / workspace through
  :func:`register_memory` providers.  Metadata reads only: nothing
  here synchronizes the card, and nothing initializes CUDA — until
  the process has initialized it, only the host RSS is reported (the
  JAX package's lazy-import rule), so a forked decode worker never
  creates a context.

Every producer shares telemetry's master switch
(``MXTPU_TELEMETRY=0``): :func:`trace_event` then returns after one
env read.  The recorder's contents dump automatically (atomic, JSONL)
on ``DataPipelineError`` and on SIGTERM/SIGUSR1, but only when
``MXTPU_TRACE_DUMP`` names a path.  Event names are the JAX package's
(the docs/observability.md catalog).
"""
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

from .utils.env import get_env
from .utils.log import get_logger

__all__ = ["FlightRecorder", "enabled", "get_recorder", "recorder",
           "trace_event", "events", "dump", "dump_on_fault",
           "install_signal_dump", "stitch_dumps",
           "compile_ledger", "CompileLedger",
           "signature_diff", "compile_totals", "register_memory",
           "register_param_opt_providers", "updater_state_arrays",
           "device_memory_stats", "update_memory_gauges",
           "reset_for_tests"]


def enabled():
    """Tracing shares the telemetry master switch: one env read."""
    from . import telemetry
    return telemetry.enabled()


def safe_list(seq, retries=4):
    """Copy a sequence another thread may be mutating: iterating a
    deque during a concurrent append/pop raises RuntimeError — retry,
    then degrade to empty rather than crash a monitoring caller.
    Shared by the recorder's lock-timeout fallback and
    ``ServingEngine.stats()``."""
    for _ in range(retries):
        try:
            return list(seq)
        except RuntimeError:
            continue
    return []


# ---------------------------------------------------------------------------
# ring buffer
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of structured events.

    Each event is a dict ``{"seq": int, "ts": float, "event": name,
    ...fields}``; the ring holds the most recent ``capacity``
    (``MXTPU_TRACE_BUFFER``) and counts what it evicted
    (``dropped``), so a dump always says how much history it lost.
    Appends take one short lock — the recorder sits on the serving
    decode loop and the training step path, so there is no fan-out,
    no allocation beyond the event dict, and no I/O."""

    def __init__(self, capacity=None):
        cap = int(capacity if capacity is not None
                  else get_env("MXTPU_TRACE_BUFFER"))
        self.capacity = max(1, cap)
        self._buf = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.recorded = 0
        self._dropped = 0

    def record(self, event, **fields):
        fields["event"] = event
        fields["ts"] = time.time()
        # timeout-acquire, like _snapshot's signal path: a SIGTERM
        # handler's own producers (serve_snapshot/serve_drain) may
        # run on the very thread interrupted mid-record() with the
        # lock held — a blocking acquire would deadlock the handler
        # the instant before it writes the crash-resume file.  One
        # second never fires under real contention (the hold is a
        # few dict ops); on timeout the event is dropped and
        # counted, which beats hanging the process.
        if not self._lock.acquire(timeout=1.0):
            self._dropped += 1      # best-effort count (unlocked)
            return
        try:
            fields["seq"] = next(self._seq)
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1  # ring bound evicts the oldest
            self._buf.append(fields)
            self.recorded += 1
        finally:
            self._lock.release()

    @property
    def dropped(self):
        """Events evicted by the ring *bound* so far (plus the
        vanishingly rare producer that gave up its lock-timeout in
        a signal-deadlock window).  Deliberate ``clear()`` calls do
        not count — a post-mortem's drop count must mean 'history
        the ring could not keep'."""
        return self._dropped

    def _snapshot(self, lock_timeout=None):
        """Copy of the buffer.  ``lock_timeout`` exists for the
        signal path: a SIGTERM handler runs on the main thread,
        which may be the very thread interrupted mid-``record()``
        with the lock held — blocking would deadlock the dump the
        signal asked for.  On timeout, fall back to an unlocked copy
        (retried: a concurrent append can raise RuntimeError
        mid-iteration)."""
        if lock_timeout is None:
            with self._lock:
                return list(self._buf)
        if self._lock.acquire(timeout=lock_timeout):
            try:
                return list(self._buf)
            finally:
                self._lock.release()
        return safe_list(self._buf)

    def events(self, event=None, **match):
        """Snapshot of buffered events, optionally filtered by event
        name and/or exact field values (host-side copy)."""
        evs = self._snapshot()
        if event is not None:
            evs = [e for e in evs if e.get("event") == event]
        for k, v in match.items():
            evs = [e for e in evs if e.get(k) == v]
        return evs

    def clear(self):
        with self._lock:
            self._buf.clear()

    def dump(self, path, reason="manual", lock_timeout=None):
        """Atomic JSONL dump: one header line (reason, rank, drop
        count), then one line per buffered event, oldest first —
        temp + rename via resilience, so a crash mid-dump never
        leaves a torn post-mortem.  ``lock_timeout`` — see
        :meth:`_snapshot`; signal-context dumps pass one so a lock
        held by the interrupted thread cannot deadlock them."""
        from . import resilience
        evs = self._snapshot(lock_timeout=lock_timeout)
        try:
            rank = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)
        except ValueError:
            rank = 0
        header = {"flight_recorder": 1, "reason": reason,
                  "ts": time.time(), "rank": rank, "pid": os.getpid(),
                  "events": len(evs), "dropped": self.dropped}
        lines = [json.dumps(header, sort_keys=True)]
        lines += [json.dumps(e, sort_keys=True, default=str)
                  for e in evs]
        resilience._replace_with_bytes(
            path, ("\n".join(lines) + "\n").encode(), sync_dir=False)
        return path


class _NullRecorder:
    """Disabled-mode stand-in: absorbs every producer with zero
    state, zero locks (the tracing analog of telemetry.NULL_METRIC)."""

    __slots__ = ()
    capacity = 0
    recorded = 0
    dropped = 0

    def record(self, event, **fields):
        pass

    def events(self, event=None, **match):
        return []

    def clear(self):
        pass

    def dump(self, path, reason="manual", lock_timeout=None):
        return None


NULL_RECORDER = _NullRecorder()

_RECORDER_LOCK = threading.Lock()
_RECORDER = {"obj": None}


def get_recorder():
    """The process-wide recorder (created on first use so tests can
    re-size it via MXTPU_TRACE_BUFFER + reset_for_tests)."""
    rec = _RECORDER["obj"]
    if rec is None:
        with _RECORDER_LOCK:
            rec = _RECORDER["obj"]
            if rec is None:
                rec = _RECORDER["obj"] = FlightRecorder()
    return rec


def recorder():
    """The live recorder, or the shared no-op when disabled."""
    if not enabled():
        return NULL_RECORDER
    return get_recorder()


def trace_event(event, **fields):
    """Append one structured event to the flight recorder.

    The single producer entry point: disabled mode costs one env
    read; event names are lint-checked against the
    docs/observability.md catalog."""
    if not enabled():
        return
    get_recorder().record(event, **fields)


def events(event=None, **match):
    """Filtered view of the current ring contents."""
    return recorder().events(event, **match)


# ---------------------------------------------------------------------------
# fault dumps
# ---------------------------------------------------------------------------


def _dump_path():
    """The automatic-dump target, suffixed per rank in multi-rank
    runs: launch.py passes MXTPU_TRACE_DUMP through unchanged, so
    without the suffix every worker's atomic rename would clobber
    the same file and the faulting rank's post-mortem could lose to
    a healthy rank's SIGTERM dump (last rename wins).  Single-process
    runs (MXTPU_WORKER_RANK unset) keep the exact configured path."""
    path = get_env("MXTPU_TRACE_DUMP") or None
    if path is None:
        return None
    rank = os.environ.get("MXTPU_WORKER_RANK")
    if rank is not None:
        try:
            root, ext = os.path.splitext(path)
            path = f"{root}.rank{int(rank)}{ext}"
        except ValueError:
            pass
    return path


def dump(path=None, reason="manual", lock_timeout=None):
    """Dump the ring to ``path`` (default ``MXTPU_TRACE_DUMP``).
    Returns the written path, or None when no target is configured.
    Dumps even when telemetry was disabled mid-run — whatever the
    ring holds is what you get."""
    path = path or _dump_path()
    if path is None:
        return None
    return get_recorder().dump(path, reason=reason,
                               lock_timeout=lock_timeout)


def dump_on_fault(reason, lock_timeout=None):
    """Best-effort fault dump: called from exception constructors and
    the serving eviction path, so it must never raise and never
    recurse (a dump failure inside DivergedError handling must not
    mask the divergence)."""
    try:
        return dump(reason=reason, lock_timeout=lock_timeout)
    except Exception:
        return None


_SIGNAL_STATE = {"installed": False}


def install_signal_dump(signums=None):
    """Chainingly install SIGTERM/SIGUSR1 handlers that dump the
    flight recorder before the previous disposition runs — the
    launcher's hung-worker kill (SIGTERM after SIGKILL escalation)
    and an operator's ``kill -USR1`` both leave a post-mortem.

    No-op unless ``MXTPU_TRACE_DUMP`` is set, outside the main
    thread (signal.signal would raise), or already installed."""
    import signal as _signal
    if _SIGNAL_STATE["installed"] or _dump_path() is None:
        return False
    if threading.current_thread() is not threading.main_thread():
        return False
    signums = signums or (_signal.SIGTERM, _signal.SIGUSR1)
    for signum in signums:
        prev = _signal.getsignal(signum)

        def handler(num, frame, prev=prev):
            # timeout-acquire: the handler interrupts the main
            # thread, which may itself hold the recorder lock
            dump_on_fault(f"signal_{num}", lock_timeout=1.0)
            if callable(prev):
                prev(num, frame)
            elif prev == _signal.SIG_IGN:
                # an explicitly-ignored signal stays ignored (a
                # parent that set SIG_IGN meant "only SIGKILL stops
                # this worker") — dump only, never escalate to kill
                return
            elif num != _signal.SIGUSR1:
                # fatal signals (SIGTERM) keep their prior exit
                # behavior — including prev=None (a handler
                # installed by non-Python code, unknowable here):
                # falling through to the default beats swallowing
                # the signal and leaving an unkillable worker.
                # SIGUSR1's default is ALSO terminate, which would
                # turn the operator's "dump now" poke into a kill —
                # dump-only unless the app had its own handler
                _signal.signal(num, _signal.SIG_DFL)
                _signal.raise_signal(num)

        try:
            _signal.signal(signum, handler)
        except (ValueError, OSError):
            return False
    _SIGNAL_STATE["installed"] = True
    return True


def _stitch_source(item):
    """Normalize one stitch input to ``(src, iterable-of-records)``.

    Accepts a dump-file path (str / os.PathLike), a live ``tracez``
    reply dict (``{"events": [...], "rank": N, ...}``), or a bare
    list of event dicts — so a fleet timeline can be assembled from
    *running* processes (debugz ``tracez``) mixed with post-mortem
    dump files, without killing anything.  Unreadable paths yield an
    empty iterable (a killed rank never dumps; the rest still
    stitch)."""
    if isinstance(item, dict):
        rank = item.get("rank")
        src = (f"live:rank{rank}" if rank is not None
               else "live:" + str(item.get("role", "?")))
        return src, [e for e in item.get("events", ())
                     if isinstance(e, dict)]
    if isinstance(item, (list, tuple)):
        return "live", [e for e in item if isinstance(e, dict)]
    try:
        with open(item, "r", encoding="utf-8") as fh:
            raw = fh.read().splitlines()
    except OSError:
        return os.path.basename(str(item)), []
    recs = []
    for line in raw:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            recs.append(rec)
    return os.path.basename(str(item)), recs


def stitch_dumps(paths, rid=None):
    """Merge flight-recorder sources into one fleet timeline.

    The router and each serving replica are separate processes, so
    one request's hops — ``router_dispatch`` on the router,
    ``fleet_dispatch``/``fleet_terminal`` on a replica,
    ``router_terminal`` back on the router — land in separate dump
    files (``MXTPU_TRACE_DUMP`` plus the per-rank suffix from
    ``_dump_path``).  Each element of ``paths`` is a dump-file path
    OR a live debugz ``tracez`` payload (reply dict or bare event
    list — see :func:`_stitch_source`).  This loads every source,
    tags each event with its origin (``src`` = file basename or
    ``live:rankN``), and returns one wall-clock-ordered list, ties
    broken by source then per-source ``seq``.  Events share a key:
    dispatch/terminal hops carry ``rid`` and ``replica`` on both
    sides of the wire, so ``rid=`` narrows the merge to a single
    request's cross-process story.

    Paths that do not exist are skipped — a ``router:replica:kill``
    fault dies by ``os._exit`` and never dumps; the surviving files
    still stitch.  Header lines and undecodable lines are skipped
    the same way (dumps are written atomically, but a glob may
    match a foreign or torn file)."""
    merged = []
    for item in paths:
        src, recs = _stitch_source(item)
        for rec in recs:
            if "event" not in rec:
                continue            # header / foreign line
            if rid is not None and rec.get("rid") != rid:
                continue
            rec = dict(rec)
            rec["src"] = src
            merged.append(rec)
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("src", ""),
                               e.get("seq", 0)))
    return merged


# ---------------------------------------------------------------------------
# retrace attribution
# ---------------------------------------------------------------------------


def signature_diff(sig, prior):
    """Attribute a compile to what changed.

    ``sig`` is this compile's signature — a flat dict of named
    components (``shape`` / ``dtype`` / ``static_arg`` /
    ``train_flag`` / site-specific keys) — and ``prior`` the
    signatures already compiled at the site.  Returns ``(reason,
    changed)``: the *nearest* prior entry (most matching components)
    names the miss, e.g. a second compile differing only in ``shape``
    is a shape miss, not "everything changed".  First compile at a
    site is ``first_compile``."""
    if not prior:
        return "first_compile", []

    def overlap(old):
        return sum(1 for k in sig if k in old and old[k] == sig[k])

    nearest = max(prior, key=overlap)
    keys = set(sig) | set(nearest)
    changed = sorted(k for k in keys
                     if sig.get(k) != nearest.get(k))
    return ("+".join(changed) if changed else "duplicate"), changed


# process-wide compile accounting feeding the budget watchdog
_COMPILE_LOCK = threading.Lock()
_COMPILE_TOTALS = {"events": 0, "seconds": 0.0, "warn_at": None}


def compile_totals():
    """(events, cumulative seconds) across every ledger site."""
    with _COMPILE_LOCK:
        return (_COMPILE_TOTALS["events"],
                _COMPILE_TOTALS["seconds"])


def _budget_check(site, seconds):
    """MXTPU_COMPILE_BUDGET watchdog: accumulate compile wall time
    process-wide; the first crossing of the budget warns loudly, and
    every doubling after that warns again — a retrace storm keeps
    ringing, a one-off cold compile rings once or never."""
    with _COMPILE_LOCK:
        _COMPILE_TOTALS["events"] += 1
        _COMPILE_TOTALS["seconds"] += float(seconds)
        total = _COMPILE_TOTALS["seconds"]
        budget = float(get_env("MXTPU_COMPILE_BUDGET"))
        if budget <= 0:
            return
        threshold = _COMPILE_TOTALS["warn_at"]
        if threshold is None:
            threshold = budget
        if total < threshold:
            return
        _COMPILE_TOTALS["warn_at"] = threshold * 2
        events_n = _COMPILE_TOTALS["events"]
    get_logger().warning(
        "compile budget exceeded: %.2fs cumulative compile time "
        "over %d compiles (MXTPU_COMPILE_BUDGET=%.2fs; latest site "
        "%r, +%.2fs) — check the flight recorder's 'compile' events "
        "for the signature diffs driving the retraces "
        "(docs/observability.md)", total, events_n, budget, site,
        seconds)


class CompileLedger:
    """Per-site compile bookkeeping: remembers past signatures so
    each new compile is *attributed* (signature diff vs the nearest
    cached entry), timed into the ``compile_seconds`` histogram, and
    recorded as a ``compile`` flight-recorder event."""

    MAX_SIGS = 64       # attribution memory per site, bounded

    def __init__(self, site):
        self.site = site
        self._sigs = deque(maxlen=self.MAX_SIGS)
        self._lock = threading.Lock()

    def record(self, signature, seconds, cost=None):
        """Attribute + publish one compile.  ``signature`` is the
        flat component dict (see :func:`signature_diff`); ``seconds``
        the wall-clock trace+compile time the caller measured;
        ``cost`` (optional) the analytic cost-model summary of the
        recompiled graph (``perf.CostReport.summary()``: total
        GFLOPs, GBytes, arithmetic intensity), so retrace
        attribution also says how expensive the graph is.
        Returns the attribution reason.

        Honors the disabled-mode contract: with ``MXTPU_TELEMETRY=0``
        this is one env read — no locks, no signature history, no
        budget accounting, no warnings."""
        if not enabled():
            return "disabled"
        from . import telemetry
        sig = dict(signature)
        with self._lock:
            reason, changed = signature_diff(sig, list(self._sigs))
            self._sigs.append(sig)
        telemetry.counter("compile_events_total").inc()
        telemetry.histogram("compile_seconds").observe(seconds)
        extra = {"cost": dict(cost)} if cost else {}
        trace_event("compile", site=self.site, reason=reason,
                    changed=changed, seconds=round(float(seconds), 6),
                    signature={k: repr(v) for k, v in sig.items()},
                    **extra)
        _budget_check(self.site, seconds)
        return reason


_LEDGERS_LOCK = threading.Lock()
_LEDGERS = {}


def compile_ledger(site):
    """Get-or-create the process-wide ledger for one compile site."""
    with _LEDGERS_LOCK:
        led = _LEDGERS.get(site)
        if led is None:
            led = _LEDGERS[site] = CompileLedger(site)
        return led


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------

_MEM_LOCK = threading.Lock()
_MEM_PROVIDERS = {}     # kind -> {token: provider()->iterable arrays}
_MEM_TOKEN = itertools.count()
# (kind, token) of unregistered providers, dropped under _MEM_LOCK by the
# next reader or writer: an owner's finalizer may run in a GC pass that
# fires while this thread holds the lock, so unregistering takes none
_MEM_DEAD = []
MEMORY_KINDS = ("params", "optimizer", "kv_pools")
# latest preflight memory plan (predicted peak live bytes), set by
# perf.memory_planner at bind/preflight time; the heartbeat gauges
# publish predicted-minus-measured drift against it
_MEM_PLAN = {"bytes": None, "categories": None}


def set_memory_plan(predicted_bytes, categories=None):
    """Record the planner's latest predicted peak live bytes (None
    clears).  Host-side state only — read by
    :func:`update_memory_gauges` to publish
    ``memory_plan_delta_bytes`` on the heartbeat cadence.
    ``categories`` optionally keeps the per-category byte breakdown
    (params/optimizer/activations/...) so debugz ``memz`` can serve
    the full plan, not just the total."""
    with _MEM_LOCK:
        _MEM_PLAN["bytes"] = None if predicted_bytes is None \
            else float(predicted_bytes)
        _MEM_PLAN["categories"] = (
            None if categories is None
            else {str(k): float(v) for k, v in categories.items()})


def memory_plan():
    """Latest plan as ``{"predicted_bytes", "categories"}`` (both
    None until a planner ran).  Served by debugz ``memz``."""
    with _MEM_LOCK:
        return {"predicted_bytes": _MEM_PLAN["bytes"],
                "categories": _MEM_PLAN["categories"]}


def register_memory(kind, provider, owner=None):
    """Attribute device buffers to an owner class.

    ``provider`` is a zero-arg callable returning an iterable of
    tensors or NDArrays (only those on the card count); ``kind`` is one of
    ``params`` / ``optimizer`` / ``kv_pools``.  Returns an
    unregister callable; passing ``owner`` additionally ties the
    registration's lifetime to that object (``weakref.finalize``),
    so a process that constructs engines/trainers in a loop does not
    accumulate dead provider entries — the table would otherwise
    grow forever and every heartbeat would call every dead closure.
    A provider that raises is silently skipped (a torn-down owner
    must not break the heartbeat)."""
    if kind not in MEMORY_KINDS:
        raise ValueError(
            f"unknown memory kind {kind!r}: want one of "
            f"{MEMORY_KINDS}")
    token = next(_MEM_TOKEN)
    with _MEM_LOCK:
        _drop_dead_providers()
        _MEM_PROVIDERS.setdefault(kind, {})[token] = provider

    def unregister():
        _MEM_DEAD.append((kind, token))
    if owner is not None:
        import weakref
        weakref.finalize(owner, unregister)
    return unregister


def _drop_dead_providers():
    """Forget the unregistered providers (call with _MEM_LOCK held)."""
    while _MEM_DEAD:
        kind, token = _MEM_DEAD.pop()
        _MEM_PROVIDERS.get(kind, {}).pop(token, None)


def register_param_opt_providers(owner, param_arrays, opt_arrays):
    """Register ``owner``'s params + optimizer-state memory providers.

    The shared shape of every trainer-like registration
    (gluon.Trainer, Module's eager path, parallel.SymbolTrainStep):
    ``param_arrays`` / ``opt_arrays`` take the *live* owner and
    return its arrays; this helper supplies the weakref guard (a
    collected owner yields ``[]``) and returns the unregister pair."""
    import weakref
    ref = weakref.ref(owner)

    def _wrap(fn):
        def provider():
            obj = ref()
            return [] if obj is None else fn(obj)
        return provider

    return (register_memory("params", _wrap(param_arrays),
                            owner=owner),
            register_memory("optimizer", _wrap(opt_arrays),
                            owner=owner))


def updater_state_arrays(states):
    """Flatten an Updater ``states`` tree (dicts, lists, tuples of
    NDArrays or tensors) to its raw tensors (NDArray leaves unwrap to
    their backing tensor)."""
    leaves = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif v is not None:
            d = getattr(v, "_data", None)
            leaves.append(d if d is not None else v)

    walk(states)
    return leaves


def _rss_bytes():
    """Resident set size from /proc (Linux); 0 where unavailable.
    Pure host-side file read."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _cuda_bytes(a):
    """Bytes of ``a`` when it is a tensor on the card, else 0."""
    t = getattr(a, "_data", a)
    if not getattr(t, "is_cuda", False):
        return 0
    return int(t.nbytes)


def device_memory_stats():
    """Host-side device-memory accounting snapshot.

    Everything here reads *metadata only* — the caching allocator's
    ``memory_stats()`` counters and the ``nbytes`` of registered
    tensors — never a tensor's value, so sampling synchronizes
    nothing.  Returns only the host RSS until this process has
    initialized CUDA: sampling must never create a context (a forked
    decode worker, a heartbeat thread started before the model)."""
    torch = sys.modules.get("torch")
    out = {"host_rss_bytes": _rss_bytes()}
    try:
        if torch is None or not torch.cuda.is_initialized():
            return out
        stats = [torch.cuda.memory_stats(d)
                 for d in range(torch.cuda.device_count())]
    except Exception:
        return out
    total = sum(int(st.get("allocated_bytes.all.current", 0) or 0)
                for st in stats)
    out["device_live_bytes"] = total
    with _MEM_LOCK:
        _drop_dead_providers()
        providers = {k: list(v.values())
                     for k, v in _MEM_PROVIDERS.items()}
    attributed = 0
    for kind in MEMORY_KINDS:
        kind_bytes = 0
        counted = set()
        for provider in providers.get(kind, ()):
            try:
                arrays = list(provider())
            except Exception:
                continue
            for a in arrays:
                if id(a) in counted:
                    continue
                try:
                    kind_bytes += _cuda_bytes(a)
                    counted.add(id(a))
                except Exception:
                    continue
        out[f"device_bytes_{kind}"] = kind_bytes
        attributed += kind_bytes
    # workspace = live bytes no owner claims; floored at 0 because a
    # stale provider may still hold tensors the allocator freed
    out["device_bytes_workspace"] = max(0, total - attributed)
    peak = sum(int(st.get("allocated_bytes.all.peak", 0) or 0)
               for st in stats)
    if peak:
        out["device_peak_bytes"] = peak
    return out


def update_memory_gauges():
    """Sample :func:`device_memory_stats` into telemetry gauges so
    memory rides every snapshot channel (emitter JSONL, Prometheus
    textfile, heartbeat payload -> launch.py).  No-op when telemetry
    is disabled."""
    from . import telemetry
    if not telemetry.enabled():
        return {}
    stats = device_memory_stats()
    telemetry.gauge("host_rss_bytes").set(
        stats.get("host_rss_bytes", 0))
    if "device_live_bytes" in stats:
        telemetry.gauge("device_live_bytes").set(
            stats["device_live_bytes"])
        telemetry.gauge("device_bytes_params").set(
            stats.get("device_bytes_params", 0))
        telemetry.gauge("device_bytes_optimizer").set(
            stats.get("device_bytes_optimizer", 0))
        telemetry.gauge("device_bytes_kv_pools").set(
            stats.get("device_bytes_kv_pools", 0))
        telemetry.gauge("device_bytes_workspace").set(
            stats.get("device_bytes_workspace", 0))
    if "device_peak_bytes" in stats:
        telemetry.gauge("device_peak_bytes").set(
            stats["device_peak_bytes"])
    with _MEM_LOCK:
        plan = _MEM_PLAN["bytes"]
    if plan is not None and "device_live_bytes" in stats:
        # planner drift: predicted peak minus measured live bytes
        # (positive = planner conservative); metadata math only
        delta = plan - stats["device_live_bytes"]
        telemetry.gauge("memory_plan_delta_bytes").set(delta)
        stats["memory_plan_delta_bytes"] = delta
    return stats


# ---------------------------------------------------------------------------
# test isolation
# ---------------------------------------------------------------------------


def reset_for_tests():
    """Drop the recorder, ledgers, compile totals, and memory
    providers (parallel of MetricRegistry.reset)."""
    with _RECORDER_LOCK:
        _RECORDER["obj"] = None
    with _LEDGERS_LOCK:
        _LEDGERS.clear()
    with _COMPILE_LOCK:
        _COMPILE_TOTALS.update(events=0, seconds=0.0, warn_at=None)
    with _MEM_LOCK:
        _MEM_PROVIDERS.clear()
        del _MEM_DEAD[:]
        _MEM_PLAN["bytes"] = None
        _MEM_PLAN["categories"] = None


# ---------------------------------------------------------------------------
# fork safety
# ---------------------------------------------------------------------------


def _after_fork_in_child():
    """Fresh locks in a forked child (see telemetry's twin): the
    recorder, ledgers, compile totals and memory providers each
    guard their state with a lock a parent thread may have held at
    the fork."""
    global _RECORDER_LOCK, _LEDGERS_LOCK, _COMPILE_LOCK, _MEM_LOCK
    _RECORDER_LOCK = threading.Lock()
    rec = _RECORDER["obj"]
    if rec is not None:
        rec._lock = threading.Lock()
    _LEDGERS_LOCK = threading.Lock()
    for led in list(_LEDGERS.values()):
        led._lock = threading.Lock()
    _COMPILE_LOCK = threading.Lock()
    _MEM_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_after_fork_in_child)
