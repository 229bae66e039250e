"""Resilience subsystem: retries, deadlines, atomic checkpoints,
heartbeats, and deterministic fault injection (twin of
``incubator_mxnet_tpu/resilience.py``, stdlib-only like it).

- :class:`RetryPolicy` / :func:`retry_call` — bounded retry with
  exponential backoff + jitter (the rpc reconnect paths).
- :func:`deadline_call` — run a callable under a wall-clock deadline
  in a worker thread; on expiry raise :class:`DeadlineExceededError`
  with a diagnostic instead of hanging.
- :func:`atomic_save` / :func:`validate_or_raise` — temp-file +
  fsync + rename checkpoint writes with a CRC32 sidecar, so a reader
  never observes a partial file and a corrupt one is *detected*
  rather than silently loaded.  The sidecar format is the JAX
  package's, so a file written by either package validates in the
  other.
- :func:`start_heartbeat` — a daemon thread touching a per-worker
  file so a launcher can tell *hung* from *crashed* workers.
- Deterministic fault injection via ``MXTPU_FAULT_SPEC`` so every
  path above is testable on CPU: ``scope:op:nth:kind`` (e.g.
  ``checkpoint:save:1:truncate``, ``record:read:2:corrupt``; the data
  service's decode workers and rings inject under
  ``data_service:worker`` / ``data_service:ring``); the grammar and
  the exception types are the JAX package's.

- The training-step sentinel: :class:`NumericGuard` (policy and
  accounting of the guarded updates' one finiteness scalar),
  :class:`BadStepError` and :class:`DivergedError`, and
  :func:`install_diverged_exithook` (exit 13 for divergence, 15 for
  device memory).
- Device-memory exhaustion: :class:`MemoryPlanError` (the preflight
  planner's ladder ran dry) and :class:`OomError` (memory really ran
  out); :func:`is_oom` knows torch's exhaustion
  (``torch.OutOfMemoryError``, "CUDA out of memory", cuBLAS's and
  cuDNN's allocation-failure statuses) and the JAX package's markers, so
  the synthetic ``mem:oom`` injection (:func:`check_oom`) classifies
  the same way.
"""
import math
import os
import random
import tempfile
import threading
import time
import warnings
import zlib

from .utils.env import get_env

__all__ = ["ResilienceError", "TransientError", "DeadlineExceededError",
           "CollectiveAbortedError", "DataPipelineError",
           "CheckpointCorruptError",
           "ElasticRestartRequested", "ELASTIC_EXIT_CODE",
           "RetryPolicy", "retry_call",
           "deadline_call", "call_transient_mapped", "TRANSIENT_MARKERS",
           "JOIN_TRANSIENT_MARKERS", "decode_or_corrupt",
           "parse_fault_spec", "faults_active",
           "fault_for", "inject", "reset_faults", "atomic_save",
           "damage_file",
           "atomic_write_bytes", "checksum_path", "verify_checkpoint",
           "validate_or_raise", "read_validated_bytes",
           "start_heartbeat", "stop_heartbeat", "heartbeat_age",
           "collective_timeout", "data_timeout",
           "BadStepError", "DivergedError", "NumericGuard",
           "install_diverged_exithook", "MemoryPlanError", "OomError",
           "OOM_EXIT_CODE", "is_oom", "check_oom", "as_oom_error"]


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


class ResilienceError(RuntimeError):
    """Base class for resilience-layer failures."""


class TransientError(ResilienceError):
    """A failure worth retrying (transport hiccup, injected fault)."""


class DeadlineExceededError(ResilienceError):
    """An operation ran past its wall-clock deadline."""


class CollectiveAbortedError(ResilienceError):
    """A multi-rank collective failed after being entered.

    Never retried in place: peers may have completed the op, and a
    rank-local re-entry would pair with their *next* collective.
    Recovery is the launcher restart loop's job — under
    ``tools/launch.py --elastic`` (MXTPU_ELASTIC=1) an uncaught one
    terminates the worker with :data:`ELASTIC_EXIT_CODE` so the
    restart is attributed as a coordinated elastic abort, not a
    crash.  Constructing one dumps the flight recorder when
    ``MXTPU_TRACE_DUMP`` is set: the surviving ranks' last events
    before the abort are the post-mortem an operator wants."""

    EXIT_CODE = 14

    def __init__(self, *args):
        super().__init__(*args)
        _flight_dump("collective_aborted")


class ElasticRestartRequested(ResilienceError):
    """A worker deliberately requests a coordinated elastic restart
    (e.g. re-admission of a replaced rank at a checkpoint boundary).
    Uncaught, it terminates the process with
    :data:`ELASTIC_EXIT_CODE` via the exithook — the launcher's
    --elastic loop relaunches the full target world, resuming from
    the newest sharded checkpoint generation (docs/elastic.md)."""

    EXIT_CODE = 14

    def __init__(self, *args):
        super().__init__(*args)
        _flight_dump("elastic_restart_requested")


# tools/launch.py mirrors this by value (it must run without the
# package importable); distinct from DivergedError.EXIT_CODE (13) so
# the restart ledger can tell elastic world changes from divergence
ELASTIC_EXIT_CODE = 14


class CheckpointCorruptError(ResilienceError, IOError):
    """A checkpoint file failed checksum / decode validation.

    Subclasses IOError so legacy ``except IOError`` checkpoint
    handling still catches it."""


def _flight_dump(reason):
    """Dump the flight recorder on a terminal-fault construction
    (DataPipelineError, CollectiveAbortedError).  Best-effort and strictly
    side-channel: a tracing failure must never alter the raise, and
    with MXTPU_TRACE_DUMP unset (default) this is a no-op — tests
    constructing these errors stay side-effect free."""
    try:
        from . import tracing
        tracing.dump_on_fault(reason)
    except Exception:
        pass


class DataPipelineError(ResilienceError):
    """The input pipeline failed as a *pipeline*: a prefetch worker
    raised or wedged, a DataLoader process died past its restart
    budget, or a record source exceeded its bad-record budget.

    Typed so training loops can tell "the data stopped" from a model
    or collective failure — the former is usually storage/dataset
    trouble where a restart rereads the same poison, the latter is
    what --max-restarts exists for.  Also a RuntimeError (via
    ResilienceError) so legacy ``except RuntimeError`` guards keep
    working.

    Constructing one dumps the flight recorder when
    ``MXTPU_TRACE_DUMP`` is set (see :class:`DivergedError`)."""

    def __init__(self, *args):
        super().__init__(*args)
        _flight_dump("data_pipeline_error")


class BadStepError(ResilienceError, ArithmeticError):
    """A single training step produced non-finite gradients (or a
    loss spike) under ``MXTPU_NONFINITE_POLICY=raise``.

    Also an ArithmeticError so generic numeric guards in user loops
    (``except ArithmeticError``) keep working."""


class DivergedError(ResilienceError, ArithmeticError):
    """Training diverged: MXTPU_MAX_BAD_STEPS *consecutive* steps
    were non-finite, so skipping updates can no longer save the run.

    The fit loops roll back to the newest valid checkpoint before
    re-raising this, and training mains should exit with
    :data:`EXIT_CODE` (see :func:`install_diverged_exithook`) so the
    launcher restart loop can tell divergence from an ordinary crash.
    Constructing one dumps the flight recorder when
    ``MXTPU_TRACE_DUMP`` is set."""

    EXIT_CODE = 13

    def __init__(self, *args):
        super().__init__(*args)
        _flight_dump("diverged_error")


# a worker that dies on device-memory exhaustion (predicted by the
# planner with the ladder exhausted, or a real OOM past the one-rung
# retry) exits distinctly from crashes (1), divergence (13), elastic (14)
OOM_EXIT_CODE = 15


class MemoryPlanError(ResilienceError):
    """The preflight memory gate predicts this step cannot fit and the
    degrade ladder has no rungs left.  Raised before the step is built
    or captured, with the full per-category plan in the message."""

    EXIT_CODE = OOM_EXIT_CODE

    def __init__(self, site, plan=None, rungs=(), capacity=None):
        self.site = site
        self.plan = plan
        self.rungs = list(rungs)
        self.capacity = capacity
        msg = f"memory plan overflow at {site}"
        if capacity:
            msg += f": capacity {capacity / (1 << 20):.1f}MB"
        if plan is not None:
            msg += f", predicted {plan.describe()}"
        if self.rungs:
            msg += f"; ladder exhausted after {self.rungs}"
        else:
            msg += "; no degrade rungs available"
        msg += " (MXTPU_MEM_POLICY/MXTPU_HBM_BYTES/" \
               "MXTPU_MEM_GATE_MARGIN control the gate)"
        super().__init__(msg)
        _flight_dump("memory_plan_error")


class OomError(ResilienceError):
    """Device memory actually ran out: a step or its capture raised
    torch's out-of-memory (or the ``mem:oom`` injection fired).  Typed
    so the one-rung runtime retry and the launcher can tell OOM from a
    crash; carries the planner's plan when the preflight ran."""

    EXIT_CODE = OOM_EXIT_CODE

    def __init__(self, site, cause=None, plan=None):
        self.site = site
        self.plan = plan
        msg = f"device out of memory at {site}"
        if plan is not None:
            msg += f" (planner predicted {plan.describe()})"
        if cause is not None:
            msg += f": {cause}"
        super().__init__(msg)
        _flight_dump("oom_error")


# the JAX package's markers (the synthetic mem:oom text among them) and
# torch's: the caching allocator's message, and cuBLAS's and cuDNN's
# allocation-failure statuses
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Allocator ran out", "CUBLAS_STATUS_ALLOC_FAILED",
                "CUDNN_STATUS_ALLOC_FAILED",
                "CUDNN_STATUS_NOT_ENOUGH_WORKSPACE")


def is_oom(exc):
    """True when an exception is device-memory exhaustion:
    ``torch.OutOfMemoryError``, a message with one of the markers above,
    or an already-typed :class:`OomError`; never a
    :class:`MemoryPlanError` (a predicted overflow allocated nothing)."""
    if isinstance(exc, OomError):
        return True
    if isinstance(exc, MemoryPlanError):
        return False
    import sys
    torch = sys.modules.get("torch")
    oom_type = getattr(torch, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = str(exc)
    return any(m in text for m in _OOM_MARKERS)


def check_oom(site):
    """The ``mem:oom`` injection point: raise a synthetic
    RESOURCE_EXHAUSTED at the nth guarded step, so the runtime OOM path
    (typed error, one ladder rung, one retry) runs on the CPU.  One env
    read when no fault spec is set; never touches the device."""
    if not faults_active():
        return
    if fault_for("mem", "oom") is not None:
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: injected mem:oom at {site} "
            "(synthetic device allocation failure)")


def as_oom_error(exc, site, plan=None):
    """An :class:`OomError` for a caught exception that is memory
    exhaustion, None for anything else (which the caller re-raises)."""
    if not is_oom(exc):
        return None
    return OomError(site, cause=exc, plan=plan)


# ---------------------------------------------------------------------------
# retry with exponential backoff + jitter
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Bounded exponential backoff: delay_i = min(base * 2**i, max),
    each widened by up to ``jitter`` fraction (decorrelates workers
    hammering a recovering coordinator).  ``seed`` makes the jitter
    sequence deterministic (tests).

    ``jitter=True`` (the bool, not a fraction) selects *full* jitter:
    delay_i ~ U(0, min(base * 2**i, max)).  Fractional jitter only
    spreads retries across ``jitter``x the base delay, so N fleet
    links reconnecting after the same router blip still arrive in a
    tight wave; full jitter spreads them across the whole backoff
    window (the rpc.py reconnect paths all use it).  The default
    (env-fraction) behavior is unchanged."""

    def __init__(self, max_retries=None, base_delay=None,
                 max_delay=None, jitter=None, seed=None):
        self.max_retries = max_retries if max_retries is not None \
            else get_env("MXTPU_RETRY_MAX")
        self.base_delay = base_delay if base_delay is not None \
            else get_env("MXTPU_RETRY_BASE_DELAY_S")
        self.max_delay = max_delay if max_delay is not None \
            else get_env("MXTPU_RETRY_MAX_DELAY_S")
        self.jitter = jitter if jitter is not None \
            else get_env("MXTPU_RETRY_JITTER")
        self._rng = random.Random(seed)

    def delays(self):
        """The backoff schedule: one delay per allowed retry."""
        out = []
        for i in range(self.max_retries):
            d = min(self.base_delay * (2 ** i), self.max_delay)
            if self.jitter is True:
                d = self._rng.uniform(0.0, d)
            elif self.jitter:
                d += d * self.jitter * self._rng.random()
            out.append(d)
        return out


# grpc-status / errno phrases that mark a failure as transport-shaped
# (DNS hiccup, peer restarting) rather than a permanent
# misconfiguration.  Deliberately excludes deadline/timeout phrases:
# for a *collective*, a transport deadline means some peers already
# left the op, and re-entering it would desynchronize the ranks.
TRANSIENT_MARKERS = ("UNAVAILABLE", "CONNECT", "REFUSED",
                     "UNREACHABLE", "TEMPORAR")

# The coordinator *join* is not a collective — nothing desyncs by
# retrying it — and a join deadline usually just means rank 0 is
# still binding its port, so there timeouts are worth retrying too.
JOIN_TRANSIENT_MARKERS = TRANSIENT_MARKERS + (
    "DEADLINE_EXCEEDED", "TIMED OUT", "TIMEOUT")


def call_transient_mapped(fn, *args, markers=TRANSIENT_MARKERS,
                          **kwargs):
    """Call ``fn``, re-raising transport-shaped failures (matching
    ``markers``) as :class:`TransientError` so :func:`retry_call` can
    retry them.

    Other resilience errors pass through untouched — in particular a
    :class:`DeadlineExceededError` must never be re-mapped and
    retried (re-entering a collective some peers already left would
    desynchronize the job), and neither must a permanent
    misconfiguration (it should fail on the first attempt)."""
    try:
        return fn(*args, **kwargs)
    except ResilienceError:
        raise
    except ConnectionError as exc:
        raise TransientError(str(exc)) from exc
    except (RuntimeError, OSError) as exc:
        # includes TimeoutError: whether a timeout counts as
        # transient is exactly what ``markers`` decides
        msg = (str(exc) or type(exc).__name__).upper()
        if any(m in msg for m in markers):
            raise TransientError(str(exc)) from exc
        raise


def retry_call(fn, *args, policy=None, retry_on=(TransientError,),
               op_name=None, **kwargs):
    """Call ``fn`` with bounded retries on ``retry_on`` exceptions.

    Backoff follows ``policy`` (default: env-configured
    :class:`RetryPolicy`, built lazily on the *first failure* — the
    no-failure steady state, e.g. kvstore.push per key per step,
    pays no policy construction, env reads, or RNG seeding).  The
    final failure re-raises the original exception so caller
    except-clauses keep working; each retry emits a warning naming
    the op and attempt."""
    delays = None
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if delays is None:
                delays = (policy or RetryPolicy()).delays()
            if attempt >= len(delays):
                raise
            name = op_name or getattr(fn, "__name__", "call")
            # failure path only: the no-retry steady state never
            # touches the registry (docs/observability.md)
            from . import telemetry
            telemetry.counter("retry_attempts_total").inc()
            warnings.warn(
                f"{name} failed (attempt {attempt + 1}/"
                f"{len(delays) + 1}: {exc}); retrying in "
                f"{delays[attempt]:.2f}s", RuntimeWarning)
            time.sleep(delays[attempt])
            attempt += 1


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class _DeadlineWorker:
    """A reusable daemon thread that runs one callable at a time.

    Reuse keeps :func:`deadline_call` off the thread-creation path —
    per-step collectives (kvstore.push per key) run under a deadline,
    so spawning a fresh thread per call would tax the training hot
    loop.  A worker whose callable blew its deadline is *abandoned*
    (its thread is wedged in the hung call and dies with the
    process); only workers that finished are returned to the idle
    pool."""

    def __init__(self):
        self._job = None
        self._ready = threading.Event()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="mxtpu-deadline-worker")
        t.start()

    def _loop(self):
        while True:
            self._ready.wait()
            self._ready.clear()
            fn, box, done = self._job
            self._job = None
            try:
                box["result"] = fn()
            except BaseException as exc:    # noqa: B036 — re-raised below
                box["error"] = exc
            done.set()

    def run(self, fn, timeout):
        """Returns (result box, finished-within-deadline flag)."""
        box, done = {}, threading.Event()
        self._job = (fn, box, done)
        self._ready.set()
        return box, done.wait(timeout)


_DL_LOCK = threading.Lock()
_DL_IDLE = []                  # finished workers, available for reuse


def deadline_call(fn, timeout, op_name="op", detail=""):
    """Run ``fn()`` with a wall-clock deadline.

    The callable runs on a (reused) daemon worker thread; if it does
    not finish within ``timeout`` seconds a
    :class:`DeadlineExceededError` is raised with
    ``op_name``/``detail`` in the message.  The worker abandoned on
    expiry is left to die with the process — there is no portable way
    to kill a thread blocked in a native collective, which is exactly
    why the *process* monitor (launch.py heartbeats) exists above
    this layer.  ``timeout <= 0`` disables the wrap."""
    if not timeout or timeout <= 0:
        return fn()
    with _DL_LOCK:
        worker = _DL_IDLE.pop() if _DL_IDLE else _DeadlineWorker()
    box, finished = worker.run(fn, timeout)
    if not finished:
        raise DeadlineExceededError(
            f"{op_name} did not complete within {timeout}s "
            f"({detail}); the operation may be hung on a dead or "
            "desynchronized peer — see docs/resilience.md")
    with _DL_LOCK:
        _DL_IDLE.append(worker)
    if "error" in box:
        raise box["error"]
    return box.get("result")


def collective_timeout():
    """Deadline for dist collectives (MXTPU_COLLECTIVE_TIMEOUT,
    seconds; 0 disables)."""
    return get_env("MXTPU_COLLECTIVE_TIMEOUT")


def data_timeout():
    """Deadline for input-pipeline queue waits (MXTPU_DATA_TIMEOUT,
    seconds; 0 disables).  Consumers of prefetch queues bound every
    ``get()`` by this so a wedged producer surfaces as a
    :class:`DataPipelineError` naming the stalled source instead of
    an eternal block."""
    return get_env("MXTPU_DATA_TIMEOUT")


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

_FAULT_LOCK = threading.Lock()
_FAULT_CACHE = (None, ())          # (raw env string, parsed specs)
_FAULT_COUNTS = {}                 # (scope, op) -> calls seen

_FAULT_KINDS = ("hang", "error", "truncate", "corrupt",
                "nan", "inf", "spike", "kill")

# numeric poison kinds: only meaningful where step numerics flow —
# gradients (scope 'grad', applied by the guarded updaters) and loss
# values (scope 'loss', applied by NumericGuard.check_loss)
_NUMERIC_KINDS = ("nan", "inf", "spike")


def parse_fault_spec(raw):
    """Parse ``MXTPU_FAULT_SPEC``: comma-separated
    ``scope:op:nth:kind`` entries — *nth* is the 1-based call index
    the fault fires on (or ``*`` for every call), *kind* one of
    hang | error | truncate | corrupt.  Raises ValueError with the
    offending entry on bad grammar."""
    specs = []
    for entry in (raw or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 4:
            raise ValueError(
                f"bad fault spec {entry!r}: want scope:op:nth:kind")
        scope, op, nth, kind = parts
        if not scope or not op:
            raise ValueError(
                f"bad fault spec {entry!r}: empty scope or op")
        if kind not in _FAULT_KINDS:
            raise ValueError(
                f"bad fault spec {entry!r}: kind {kind!r} not in "
                f"{_FAULT_KINDS}")
        if kind == "truncate" and \
                scope not in ("checkpoint", "record"):
            # data-path kinds only have an effect where file bytes
            # flow (checkpoint writes, recordio reads); accepting
            # them elsewhere would validate a spec that injects
            # nothing
            raise ValueError(
                f"bad fault spec {entry!r}: kind 'truncate' only "
                "applies to the 'checkpoint' and 'record' scopes")
        if kind == "corrupt" and \
                scope not in ("checkpoint", "record", "router",
                              "data_service"):
            # corrupt additionally applies where frame bytes flow:
            # router:net / data_service:net garble one payload byte
            # after the CRC is computed (rpc.py send path)
            raise ValueError(
                f"bad fault spec {entry!r}: kind 'corrupt' only "
                "applies to the 'checkpoint', 'record', 'router' "
                "and 'data_service' scopes")
        if kind in ("nan", "inf") and scope not in ("grad", "loss"):
            raise ValueError(
                f"bad fault spec {entry!r}: kind {kind!r} only "
                "applies to the 'grad' and 'loss' scopes")
        if kind == "spike" and scope != "loss":
            raise ValueError(
                f"bad fault spec {entry!r}: kind 'spike' only "
                "applies to the 'loss' scope")
        if scope == "mem" and kind != "error":
            # mem:oom models device allocation failure: the guarded
            # compile/step sites (resilience.check_oom) raise a
            # synthetic RESOURCE_EXHAUSTED — the only kind with a
            # defined meaning there
            raise ValueError(
                f"bad fault spec {entry!r}: the 'mem' scope only "
                "accepts kind 'error' (synthetic RESOURCE_EXHAUSTED "
                "at the nth guarded compile/step)")
        if kind == "kill" and scope not in ("elastic", "router",
                                            "data_service"):
            # hard process death is a cross-process layer's test
            # vector (a rank dying mid-step for the elastic restart
            # loop, a replica dying mid-dispatch for the router's
            # failover re-dispatch, a remote shard host dying
            # mid-stream for the data plane's failover re-home);
            # accepting it on scopes with in-process recovery
            # semantics would just kill the test harness
            raise ValueError(
                f"bad fault spec {entry!r}: kind 'kill' only "
                "applies to the 'elastic', 'router' and "
                "'data_service' scopes")
        if nth != "*":
            try:
                nth = int(nth)
            except ValueError:
                raise ValueError(
                    f"bad fault spec {entry!r}: nth must be a "
                    "1-based integer or '*'") from None
            if nth < 1:
                raise ValueError(
                    f"bad fault spec {entry!r}: nth must be >= 1")
        specs.append((scope, op, nth, kind))
    return specs


def _specs():
    global _FAULT_CACHE
    raw = get_env("MXTPU_FAULT_SPEC")
    if _FAULT_CACHE[0] != raw:
        _FAULT_CACHE = (raw, tuple(parse_fault_spec(raw)))
    return _FAULT_CACHE[1]


def faults_active():
    """True when MXTPU_FAULT_SPEC declares at least one fault."""
    return bool(_specs())


def fault_for(scope, op):
    """Advance the (scope, op) call counter and return the fault
    kind due on this call, or None.  Counting only happens while a
    spec is set, so the production fast path costs one env read."""
    specs = _specs()
    if not specs:
        return None
    with _FAULT_LOCK:
        n = _FAULT_COUNTS.get((scope, op), 0) + 1
        _FAULT_COUNTS[(scope, op)] = n
    for s_scope, s_op, s_nth, s_kind in specs:
        if s_scope == scope and s_op == op and \
                (s_nth == "*" or s_nth == n):
            return s_kind
    return None


def reset_faults():
    """Clear injection call counters (test isolation)."""
    with _FAULT_LOCK:
        _FAULT_COUNTS.clear()


def inject(scope, op):
    """Fire any fault due for this (scope, op) call.

    ``error`` raises :class:`TransientError`; ``hang`` sleeps for
    MXTPU_FAULT_HANG_S (run this *inside* a deadline-wrapped callable
    so the deadline, not the sleep, decides the outcome);
    ``truncate``/``corrupt`` are returned for data-path callers
    (atomic_save, sharded checkpoint shard writes) to apply, as are
    the numeric kinds ``nan``/``inf``/``spike`` for the
    step-sentinel callers (guarded updaters poison a gradient,
    check_loss poisons the loss — docs/numeric_stability.md);
    ``kill`` (scopes ``elastic`` and ``router``) hard-exits the
    process — the elastic restart loop's and the serving router's
    failover test vector."""
    kind = fault_for(scope, op)
    if kind == "error":
        raise TransientError(
            f"injected transient error for {scope}:{op}")
    if kind == "hang":
        time.sleep(get_env("MXTPU_FAULT_HANG_S"))
        return None
    if kind == "kill":
        # a rank dying mid-step (OOM kill, host loss): hard exit, no
        # teardown, no atexit — exactly what the elastic restart
        # loop must recover from (docs/elastic.md failure matrix)
        import sys
        print(f"MXTPU_KILLED injected {scope}:{op} kill "
              f"(pid {os.getpid()})", file=sys.stderr, flush=True)
        os._exit(1)
    return kind


# ---------------------------------------------------------------------------
# atomic, checksummed checkpoint io
# ---------------------------------------------------------------------------


def checksum_path(path):
    """Sidecar path holding "crc32_hex size" for ``path``."""
    return path + ".crc32"


def _read_sidecar(side):
    """Parse a sidecar file ("crc32hex size") -> (crc, size).
    Raises ValueError/OSError on a malformed or unreadable one —
    the single definition of the sidecar format on the read side."""
    with open(side, "rb") as f:
        want_crc, want_size = f.read().split()
    return int(want_crc, 16), int(want_size)


def _file_crc(path):
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _write_tmp(path, writer):
    """``writer(fileobj)`` into a same-directory fsynced temp file;
    returns the temp path (cleaned up on writer failure)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


def _fsync_dir(path):
    """fsync the directory holding ``path`` so a just-committed
    rename/unlink survives power loss, not only process death.  Some
    filesystems refuse dir fsync — then rename ordering is all we
    get, which still covers every process-crash point."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _replace_with_bytes(path, data, sync_dir=True):
    """Write ``data`` to ``path`` via temp + fsync + rename (+ dir
    fsync unless ``sync_dir=False`` — heartbeats skip it: their
    freshness is mtime-based and moot after a power loss)."""
    tmp = _write_tmp(path, lambda f: f.write(data))
    try:
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    if sync_dir:
        _fsync_dir(path)


def damage_file(path, kind):
    """Apply an injected ``truncate``/``corrupt`` to an on-disk file
    WITHOUT touching its sidecar — the single definition of the
    fault-injection damage semantics (used by :func:`atomic_save` on
    the temp file pre-rename and by the sharded-checkpoint writer on
    a committed shard), so the torn/bit-rot states the validation
    layer must catch stay identical everywhere.  Unknown kinds are a
    no-op."""
    if kind == "truncate":
        os.truncate(path, max(1, os.path.getsize(path) // 2))
    elif kind == "corrupt":
        with open(path, "r+b") as f:
            first = f.read(1)
            f.seek(0)
            f.write(bytes([first[0] ^ 0xFF]) if first else b"\xff")


def atomic_save(path, writer):
    """Atomically write a checkpoint: ``writer(fileobj)`` produces
    the payload into a same-directory temp file, which is fsynced and
    renamed over ``path`` only once complete — a concurrent reader
    sees either the old file or the new one, never a torn write.  The
    stale CRC32+size sidecar (``path.crc32``) is removed *before* the
    data rename and the fresh one written right after, so no crash
    point pairs a data file with a mismatched sidecar (which
    validate_or_raise would reject, blocking resume from a file that
    is in fact complete): a crash before the data rename leaves the
    old data sidecar-less but intact, one between rename and sidecar
    write leaves the new data sidecar-less but complete — both load,
    since a missing sidecar passes validation.  The containing
    directory is fsynced after the data rename, so the same
    crash-point analysis holds across power loss, not just process
    death.

    Injection point ``checkpoint:save`` — ``truncate`` cuts the temp
    file in half and ``corrupt`` flips a byte *after* the sidecar
    checksum is taken, deterministically producing the torn/bit-rot
    states the load-side fallback defends against."""
    kind = inject("checkpoint", "save")
    tmp = _write_tmp(path, writer)
    try:
        crc, size = _file_crc(tmp)
        damage_file(tmp, kind)
        try:
            os.unlink(checksum_path(path))
        except FileNotFoundError:
            pass
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    # commit the unlink+rename before the new sidecar can land: a
    # power loss must never resurrect the old sidecar next to the
    # new data (= spurious CRC veto on a complete file)
    _fsync_dir(path)
    _replace_with_bytes(checksum_path(path),
                        f"{crc:08x} {size}\n".encode())


def atomic_write_bytes(path, data):
    """Atomic checksummed write of a bytes payload."""
    atomic_save(path, lambda f: f.write(data))


def verify_checkpoint(path, require_sidecar=False):
    """True when ``path`` exists and matches its CRC32 sidecar.

    A missing sidecar passes (pre-resilience checkpoints stay
    loadable) unless ``require_sidecar``."""
    if not os.path.exists(path):
        return False
    side = checksum_path(path)
    if not os.path.exists(side):
        return not require_sidecar
    try:
        want_crc, want_size = _read_sidecar(side)
        crc, size = _file_crc(path)
        return crc == want_crc and size == want_size
    except (ValueError, OSError):
        return False


def read_validated_bytes(path):
    """Read ``path`` once and validate the bytes against the CRC32
    sidecar when one exists (missing sidecar passes, as everywhere).

    Single-pass replacement for ``validate_or_raise`` + re-open, for
    payloads the caller decodes from memory anyway (pickle optimizer
    states).  Big array checkpoints (``nd.load``) instead stream the
    CRC and decode from disk — holding a multi-GB raw payload would
    double peak host RAM exactly when the decoded arrays need it.

    A mismatch is re-read once before being declared corruption: a
    concurrent atomic_save can land its rename between our data read
    and sidecar read, pairing old bytes with the new sidecar — the
    second read sees a settled pair, so a real corruption still
    raises and a mid-save race never vetoes a healthy file."""
    for attempt in (0, 1):
        with open(path, "rb") as f:
            data = f.read()
        side = checksum_path(path)
        if not os.path.exists(side):
            return data
        try:
            want_crc, want_size = _read_sidecar(side)
            ok = (zlib.crc32(data) & 0xFFFFFFFF) == want_crc \
                and len(data) == want_size
        except (ValueError, OSError):
            ok = False
        if ok:
            return data
    raise CheckpointCorruptError(
        f"checkpoint {path} failed CRC32 validation "
        f"(truncated or corrupt; sidecar {checksum_path(path)})")


def decode_or_corrupt(fname, fn):
    """Run a *pure decode* step ``fn()`` (pickle.loads, archive
    parse — no application side effects), mapping any failure to
    :class:`CheckpointCorruptError`.

    Legacy pre-sidecar files have no CRC to validate against, so a
    truncated one passes :func:`validate_or_raise` and only fails
    here — resume guards catching IOError/CheckpointCorruptError
    must see that failure too, not a raw pickle error.  A corrupt
    pickle stream can raise nearly anything (UnpicklingError,
    EOFError, AttributeError, ImportError, KeyError…), which is why
    ``fn`` must not also *apply* the payload: an error from applying
    a well-formed object (optimizer-config mismatch in set_states)
    is not corruption and must stay loud, or the states-degrade path
    would silently discard a healthy file."""
    try:
        return fn()
    except ResilienceError:
        raise
    except Exception as exc:
        raise CheckpointCorruptError(
            f"checkpoint {fname} failed to decode ({exc}); "
            "truncated or corrupt") from exc


def validate_or_raise(path):
    """Raise :class:`CheckpointCorruptError` when ``path`` fails its
    sidecar check (missing sidecars pass, as in verify_checkpoint).
    A mismatch is re-checked once — see read_validated_bytes for the
    concurrent-save race this absorbs."""
    if os.path.exists(path) and not verify_checkpoint(path) \
            and not verify_checkpoint(path):
        raise CheckpointCorruptError(
            f"checkpoint {path} failed CRC32 validation (truncated "
            "or corrupt; sidecar " + checksum_path(path) + ")")


# ---------------------------------------------------------------------------
# worker heartbeats
# ---------------------------------------------------------------------------

_HB_LOCK = threading.Lock()
_HB_STATE = {"thread": None, "stop": None, "path": None,
             "last_beat": None}


def heartbeat_age():
    """Seconds since this process last wrote its own heartbeat, or
    None when the beat never fired (disabled / not started).  Local
    monotonic bookkeeping — debugz ``healthz`` serves it without
    touching the heartbeat file."""
    with _HB_LOCK:
        last = _HB_STATE["last_beat"]
    if last is None:
        return None
    return time.monotonic() - last


def _beat(path):
    """One heartbeat: atomically refresh ``path`` with a timestamp
    (rename, so the monitor never reads a partial write).  When
    telemetry is on, the worker's current metric snapshot rides along
    as a second JSON line — launch.py aggregates these into its
    cluster status line and final run report; mtime-based monitors
    and first-line parsers are unaffected.  A telemetry failure must
    never silence the liveness signal."""
    # an absolute stamp the launcher monitor reads across processes —
    # never subtracted against a deadline
    payload = f"{time.time():.3f}\n"  # wallclock-ok: monitor stamp
    try:
        from . import telemetry
        extra = telemetry.heartbeat_payload()
        if extra:
            payload += extra + "\n"
    except Exception:
        pass
    _replace_with_bytes(path, payload.encode(), sync_dir=False)
    with _HB_LOCK:
        _HB_STATE["last_beat"] = time.monotonic()


def start_heartbeat(path=None, interval=None):
    """Start the per-worker heartbeat daemon thread (idempotent for
    the same path; a new path stops the old beat and re-targets).

    Touches ``path`` (default MXTPU_HEARTBEAT_FILE; unset → no-op)
    every ``interval`` seconds (default MXTPU_HEARTBEAT_INTERVAL).
    Because it is a plain Python daemon thread it keeps beating while
    the main thread blocks in a GIL-releasing collective, but stops
    when the process is truly wedged (SIGSTOP, C-level deadlock
    holding the GIL) — which is exactly the distinction the launcher
    monitor needs.  Injection point ``heartbeat:beat`` with ``hang``
    silences the beat (simulated wedge) without stopping the worker.

    Returns the heartbeat path, or None when disabled."""
    path = path or get_env("MXTPU_HEARTBEAT_FILE") or None
    if path is None:
        return None
    interval = interval if interval is not None \
        else get_env("MXTPU_HEARTBEAT_INTERVAL")
    with _HB_LOCK:
        if _HB_STATE["thread"] is not None and \
                _HB_STATE["thread"].is_alive():
            if _HB_STATE["path"] == path:
                return path
            # re-targeted (fresh per-attempt file after a dist
            # re-init): stop the old beat so the monitor never
            # watches a path nobody refreshes
            _HB_STATE["stop"].set()
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                if fault_for("heartbeat", "beat") == "hang":
                    return      # beat silenced: monitor sees a wedge
                try:
                    _beat(path)
                except OSError:
                    pass        # dir vanished mid-teardown: harmless
                stop.wait(interval)

        t = threading.Thread(target=loop, daemon=True,
                             name="mxtpu-heartbeat")
        _HB_STATE.update(thread=t, stop=stop, path=path)
        t.start()
        return path


def stop_heartbeat():
    """Stop the heartbeat thread (tests / clean shutdown)."""
    with _HB_LOCK:
        if _HB_STATE["stop"] is not None:
            _HB_STATE["stop"].set()
        t = _HB_STATE["thread"]
        _HB_STATE.update(thread=None, stop=None, path=None)
    if t is not None and t.is_alive():
        t.join(timeout=5)


# ---------------------------------------------------------------------------
# training-step sentinel
# ---------------------------------------------------------------------------


class NumericGuard:
    """Policy and accounting for the training-step sentinel.

    The guarded update paths (``optimizer.GuardedUpdater``,
    ``gluon.Trainer.step``, Module's fused step) reduce a step's
    gradients to ONE on-device finiteness scalar; this class decides
    what the host does with it.  ``MXTPU_NONFINITE_POLICY``:

    - ``off``   — sentinel disabled (default; no cost).
    - ``warn``  — warn on a bad step but apply the update anyway.
    - ``skip``  — skip the update (weights, optimizer state and the
      LR-scheduler/step-count advance all stay untouched).
    - ``raise`` — raise :class:`BadStepError` on the first bad step.

    The device-to-host read happens every ``MXTPU_GUARD_INTERVAL``
    guarded steps (``checks`` counts them).  ``MXTPU_MAX_BAD_STEPS``
    *consecutive* bad verdicts raise :class:`DivergedError` whatever the
    policy.  :meth:`check_loss` judges a host-side loss (non-finite, or
    ``MXTPU_LOSS_SPIKE_FACTOR`` above the running mean).  The injection
    scopes ``grad:nonfinite`` (applied by the guarded updaters) and
    ``loss:spike`` (applied here) drive every policy on the CPU."""

    POLICIES = ("off", "warn", "skip", "raise")

    def __init__(self, policy=None, interval=None, max_bad_steps=None,
                 spike_factor=None, name="train"):
        self.policy = (policy if policy is not None
                       else get_env("MXTPU_NONFINITE_POLICY")).lower()
        if self.policy not in self.POLICIES:
            raise ValueError(
                f"bad MXTPU_NONFINITE_POLICY {self.policy!r}: want "
                f"one of {self.POLICIES}")
        self.interval = max(1, int(
            interval if interval is not None
            else get_env("MXTPU_GUARD_INTERVAL")))
        self.max_bad_steps = int(
            max_bad_steps if max_bad_steps is not None
            else get_env("MXTPU_MAX_BAD_STEPS"))
        self.spike_factor = float(
            spike_factor if spike_factor is not None
            else get_env("MXTPU_LOSS_SPIKE_FACTOR"))
        self.name = name
        self.steps = 0              # guarded steps begun
        self.checks = 0             # host reads consumed (sync cost)
        self.bad_steps = 0          # bad verdicts seen (total)
        self.consecutive_bad = 0
        self.skipped_steps = 0
        self._loss_ema = None
        self._warned_skip = False

    @property
    def enabled(self):
        return self.policy != "off"

    @property
    def drops_updates(self):
        """Whether a bad step's update must not reach the weights
        (``skip`` and ``raise``): the fused paths then route the update
        through the on-device select.  ``warn`` applies it."""
        return self.policy in ("skip", "raise")

    def begin_step(self):
        """Advance the guarded-step counter; True when this step is due
        a host read of the finiteness scalar (every ``interval``-th
        guarded step)."""
        due = self.enabled and (self.steps % self.interval == 0)
        self.steps += 1
        return due

    def record(self, finite, what="gradients", dropped=1):
        """Consume one host-read verdict -> ``"ok"`` | ``"skip"``.

        Applies the policy, tracks consecutive bad steps and raises
        :class:`DivergedError` once ``max_bad_steps`` consecutive
        verdicts were bad (0 disables it).  ``dropped`` is how many
        updates this bad verdict stands for (a window's exact on-device
        bad count on the fused paths)."""
        from . import telemetry, tracing
        self.checks += 1
        if finite:
            self.consecutive_bad = 0
            telemetry.gauge("sentinel_consecutive_bad").set(0)
            return "ok"
        self.bad_steps += 1
        self.consecutive_bad += 1
        telemetry.counter("sentinel_bad_steps_total").inc()
        telemetry.gauge("sentinel_consecutive_bad").set(
            self.consecutive_bad)
        tracing.trace_event(
            "sentinel_bad_step", guard=self.name, what=what,
            step=self.steps, consecutive=self.consecutive_bad,
            policy=self.policy)
        msg = (f"non-finite {what} in guarded step {self.steps} "
               f"({self.name}; consecutive bad: "
               f"{self.consecutive_bad})")
        if self.max_bad_steps > 0 and \
                self.consecutive_bad >= self.max_bad_steps:
            telemetry.counter("sentinel_divergences_total").inc()
            tracing.trace_event(
                "sentinel_diverged", guard=self.name,
                step=self.steps, consecutive=self.consecutive_bad)
            raise DivergedError(
                f"{msg}: {self.max_bad_steps} consecutive bad steps "
                "— training diverged; roll back to the newest valid "
                "checkpoint")
        if self.policy == "raise":
            raise BadStepError(msg)
        if self.policy == "warn":
            warnings.warn(msg + "; applying the update anyway "
                          "(MXTPU_NONFINITE_POLICY=warn)",
                          RuntimeWarning)
            return "ok"
        self.skipped_steps += max(int(dropped), 1)
        telemetry.counter("sentinel_skipped_steps_total").inc(
            max(int(dropped), 1))
        if not self._warned_skip:
            warnings.warn(
                msg + "; skipping the update (weights, optimizer "
                "state, and LR schedule untouched; warned once)",
                RuntimeWarning)
            self._warned_skip = True
        return "skip"

    def check_loss(self, value, what="loss"):
        """Judge a host-side loss scalar -> ``"ok"`` | ``"skip"``.

        Injection point ``loss:spike`` (kinds nan/inf/spike).  A
        non-finite loss is always bad; with ``spike_factor`` > 0 a
        finite loss larger than ``spike_factor`` times the running mean
        of the earlier good losses is bad too."""
        if not self.enabled:
            return "ok"
        kind = inject("loss", "spike") if faults_active() else None
        v = float(value)
        injected_spike = kind == "spike"
        if kind == "nan":
            v = float("nan")
        elif kind == "inf":
            v = float("inf")
        elif injected_spike:
            base = abs(self._loss_ema) if self._loss_ema else 1.0
            v = base * max(self.spike_factor, 2.0) * 10.0
        finite = math.isfinite(v)
        # an injected spike is bad by definition, whatever the
        # detector's threshold
        spiked = injected_spike or (
            finite and self.spike_factor > 0
            and self._loss_ema is not None
            and abs(v) > self.spike_factor
            * max(abs(self._loss_ema), 1e-12))
        verdict = self.record(finite and not spiked, what=what)
        if finite and not spiked:
            self._loss_ema = v if self._loss_ema is None \
                else 0.9 * self._loss_ema + 0.1 * v
        return verdict


_DIVERGED_HOOK = {"installed": False}


def install_diverged_exithook():
    """Make an uncaught :class:`DivergedError` end the process with
    exit code 13, and an uncaught :class:`OomError` or
    :class:`MemoryPlanError` with :data:`OOM_EXIT_CODE` (15), instead
    of the generic 1, so a restart loop can tell divergence and memory
    exhaustion from a crash.  An uncaught
    :class:`ElasticRestartRequested` maps to :data:`ELASTIC_EXIT_CODE`
    (14).  Idempotent; chains to the previous excepthook."""
    import sys
    if _DIVERGED_HOOK["installed"]:
        return
    _DIVERGED_HOOK["installed"] = True
    prev = sys.excepthook

    def hook(tp, val, tb):
        prev(tp, val, tb)
        code = None
        if isinstance(val, DivergedError):
            code = DivergedError.EXIT_CODE
        elif isinstance(val, (OomError, MemoryPlanError)):
            code = OOM_EXIT_CODE
        elif isinstance(val, ElasticRestartRequested):
            code = ELASTIC_EXIT_CODE
        if code is not None:
            sys.stdout.flush()
            sys.stderr.flush()
            # an excepthook cannot set the exit status: the traceback
            # is printed and the buffers flushed, so exit hard
            os._exit(code)

    sys.excepthook = hook


# ---------------------------------------------------------------------------
# fork safety
# ---------------------------------------------------------------------------


def _after_fork_in_child():
    """Fresh locks in a forked child (a decode worker calls
    :func:`inject` on every batch): a lock a parent thread held at
    the fork would stay held in the child.  The heartbeat and
    deadline-worker threads did not survive the fork, so their slots
    are cleared."""
    global _FAULT_LOCK, _HB_LOCK, _DL_LOCK
    _FAULT_LOCK = threading.Lock()
    _HB_LOCK = threading.Lock()
    _HB_STATE.update(thread=None, stop=None, path=None)
    _DL_LOCK = threading.Lock()
    del _DL_IDLE[:]


os.register_at_fork(after_in_child=_after_fork_in_child)
