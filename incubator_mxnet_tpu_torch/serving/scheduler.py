"""Continuous-batching scheduler state: requests, slots, queue (twin
of ``incubator_mxnet_tpu/serving/scheduler.py``; pure host code).

Policy (the JAX package's docs/serving.md):

- **FIFO admission, prefill-prioritized.**  Every engine iteration
  first fills free batch slots from the waiting queue (one prefill
  per admission), then runs ONE decode step for the whole batch —
  so a new request's first token never waits behind an entire
  stream's decode, and decode throughput is only briefly traded for
  time-to-first-token.
- **Preemption by block exhaustion.**  When a running sequence needs
  its next KV block and the pool (after prefix-cache eviction) has
  none, the LATEST-admitted running request is preempted: its blocks
  free immediately, and it re-queues at the FRONT with its generated
  tokens intact.  Re-admission re-prefills prompt+generated — with
  the prefix cache warm this is usually a cheap suffix prefill — and
  greedy decoding makes the recompute exact, so preemption is
  invisible in the output stream.
- **Retirement on the spot.**  A request that emits its last token
  (budget or EOS) frees its blocks in the same iteration, so the
  next iteration's admissions see the memory.

The scheduler is pure host-side bookkeeping; device state (pools,
the captured decode step) lives in engine.py.
"""
import threading
import time
from collections import deque

__all__ = ["Request", "Scheduler", "ServingError", "SchedulingError",
           "ServeRejectedError", "RequestTooLargeError",
           "QUEUED", "RUNNING", "FINISHED", "FAILED", "EXPIRED",
           "CANCELLED", "TERMINAL_STATES"]

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
FAILED = "failed"
# SLO/survival terminals:
# a request whose ttft/total deadline passed before it could finish,
# and one the client cancelled (engine.cancel / abandoned stream).
# Both free their blocks and slot in the iteration that detects them.
EXPIRED = "expired"
CANCELLED = "cancelled"

TERMINAL_STATES = (FINISHED, FAILED, EXPIRED, CANCELLED)


class ServingError(RuntimeError):
    """Base class for serving-tier failures (typed so traffic code
    can tell the serving layer's own verdicts from model errors)."""


class SchedulingError(ServingError):
    """The schedule cannot make progress (e.g. a single request
    needs more blocks than the whole pool holds)."""


class ServeRejectedError(ServingError):
    """``submit()`` refused the request at admission control: the
    bounded wait queue (``MXTPU_SERVE_QUEUE_LIMIT``) or queued
    prompt-token budget (``MXTPU_SERVE_QUEUE_TOKENS``) is full, or
    the engine is draining.  Shedding at the door keeps admitted
    requests' latency bounded instead of letting the queue grow into
    unbounded TTFT collapse — callers should retry elsewhere/later."""


class RequestTooLargeError(ServingError, ValueError):
    """The request can never be served by this engine: its prompt +
    ``max_new_tokens`` exceeds the model context or needs more KV
    blocks than the whole pool holds.  Raised loudly at ``submit()``
    (and re-checked at admission for snapshot-restored requests)
    instead of leaving the request queued forever.  Also a
    ValueError so legacy size-validation handlers keep working."""


class Request:
    """One generation request flowing through the engine.

    ``prompt`` is immutable; ``generated`` accumulates emitted
    tokens (and survives preemption — re-admission prefills
    ``prompt + generated``).  Timing fields are host monotonic
    stamps (queue wait, TTFT, per-token latency).
    """

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_id", "state",
                 "generated", "block_ids", "n_past", "slot",
                 "admit_seq", "preemptions", "error", "logits",
                 "submit_ts", "admit_ts", "first_token_ts",
                 "last_token_ts", "finish_ts", "enqueue_ts",
                 "queue_wait_s", "prefill_s", "last_slot",
                 "ttft_deadline_ts", "deadline_ts",
                 "cancel_requested", "cancel_counted")

    def __init__(self, req_id, prompt, max_new_tokens, eos_id=None):
        self.id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.state = QUEUED
        self.generated = []
        self.block_ids = []
        self.n_past = 0
        self.slot = None
        self.admit_seq = -1
        self.preemptions = 0
        self.error = None
        self.logits = None
        self.submit_ts = time.monotonic()
        self.admit_ts = None
        self.first_token_ts = None
        self.last_token_ts = None
        self.finish_ts = None
        # stats() decomposition: time spent QUEUED (accrues
        # again after every preemption — enqueue_ts re-stamps) and
        # cumulative suffix-prefill wall time (re-prefills included)
        self.enqueue_ts = self.submit_ts
        self.queue_wait_s = 0.0
        self.prefill_s = 0.0
        # pinned at FIRST admission and never cleared (the JAX
        # package's profiler lanes key on it; kept for parity)
        self.last_slot = None
        # SLO state: absolute MONOTONIC expiry stamps (None = no
        # deadline).  ttft_deadline_ts stops binding once the first
        # token lands (the stamp itself stays set — the engine's
        # armed-deadline accounting counts it until terminal);
        # deadline_ts bounds the whole request.  The engine's reap
        # sweep enforces both; snapshot/restore persists the
        # REMAINING seconds, never the stamps (a monotonic clock
        # does not survive the process).
        self.ttft_deadline_ts = None
        self.deadline_ts = None
        # set by engine.cancel() from any thread; honored (terminal
        # state CANCELLED, blocks freed) at the next engine
        # iteration.  cancel_counted marks a cancel that bumped the
        # engine's _cancels_pending counter — the lock-free
        # stream-abandon flag deliberately does NOT, and _finalize
        # must only release counts that were actually taken (an
        # uncounted decrement would starve another request's
        # pending cancel behind the reap gate)
        self.cancel_requested = False
        self.cancel_counted = False

    @property
    def done(self):
        return self.state in TERMINAL_STATES

    @property
    def tokens(self):
        """Full stream: prompt + generated so far."""
        return self.prompt + self.generated

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}t, "
                f"generated={len(self.generated)}/"
                f"{self.max_new_tokens})")


class Scheduler:
    """Waiting queue + fixed slot array for ``max_batch`` runners.

    ``queued_tokens`` tracks the summed token length (prompt +
    generated-so-far) of everything in the waiting queue — the
    admission controller's queued-prompt-token budget
    (``MXTPU_SERVE_QUEUE_TOKENS``) reads it without walking the
    queue on every ``submit()``.  Its updates take a private lock:
    client threads add (under the engine's submit lock) while the
    engine loop pops, and a lost read-modify-write would drift the
    counter for the rest of the process — shedding against a queue
    that is not actually full (or never shedding again)."""

    def __init__(self, max_batch):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 ({max_batch})")
        self.max_batch = int(max_batch)
        self.slots = [None] * self.max_batch
        self.waiting = deque()
        self.queued_tokens = 0
        self._tok_lock = threading.Lock()
        self._admit_counter = 0

    # ------------------------------------------------------- queue
    def add(self, req):
        self.waiting.append(req)
        with self._tok_lock:
            self.queued_tokens += len(req.prompt) + len(req.generated)

    def push_front(self, req):
        """Re-queue at the head (preemption / failed admission).
        Bypasses admission control by design: a preempted request
        was already admitted once — shedding it now would turn
        memory pressure into a client-visible failure."""
        self.waiting.appendleft(req)
        with self._tok_lock:
            self.queued_tokens += len(req.prompt) + len(req.generated)

    def pop_waiting(self):
        if not self.waiting:
            return None
        req = self.waiting.popleft()
        with self._tok_lock:
            self.queued_tokens -= len(req.prompt) + len(req.generated)
        return req

    def remove_waiting(self, req):
        """Remove one specific queued request in place (the reap
        sweep's deadline/cancel path).  Removal — not pop-all-and-
        re-push — so the queue never transits an empty state a
        concurrent ``submit()`` admission check or a SIGTERM-time
        ``snapshot()`` could observe.  Returns False when absent."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return False
        with self._tok_lock:
            self.queued_tokens -= len(req.prompt) + len(req.generated)
        return True

    def has_waiting(self):
        return bool(self.waiting)

    # ------------------------------------------------------- slots
    def free_slot(self):
        """Index of a free slot, or None when the batch is full."""
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def place(self, req, slot):
        assert self.slots[slot] is None
        self.slots[slot] = req
        req.slot = slot
        if req.last_slot is None:
            req.last_slot = slot    # lane pin: first admission wins
        req.state = RUNNING
        req.admit_seq = self._admit_counter
        self._admit_counter += 1

    def clear(self, req):
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None

    def running(self):
        return [r for r in self.slots if r is not None]

    def n_running(self):
        return sum(1 for r in self.slots if r is not None)

    def any_running(self):
        return any(r is not None for r in self.slots)

    def latest_running(self):
        """Preemption victim: the most recently admitted runner."""
        live = self.running()
        return max(live, key=lambda r: r.admit_seq) if live else None

    def has_work(self):
        return bool(self.waiting) or self.any_running()
