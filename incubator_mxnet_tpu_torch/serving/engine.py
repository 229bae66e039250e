"""Continuous-batching serving engine over a paged KV cache (twin of
``incubator_mxnet_tpu/serving/engine.py``).

``TransformerLM.generate`` decodes one fixed batch per call.
:class:`ServingEngine` serves a stream of requests instead:

- **Paged KV cache**: per-layer block pools (``block_table.BlockPool``);
  each request owns just the blocks its length needs, gather and
  scatter happen by block id inside the step, and refcounting makes
  shared system prompts copy-free (``cache_manager.PrefixCache``).
- **Continuous batching**: ``submit()`` enqueues, every ``step()``
  admits waiting requests into free batch slots (one suffix prefill
  each) and runs ONE decode step for the whole batch; finished requests
  retire and free their blocks the same iteration.  Liveness is data
  (scratch-block rows), not shape.
- **int8 weights** (``quantize.quantize_weights``), dequantized at use.
- **SLOs**: per-request TTFT and total deadlines on monotonic clocks
  (terminal ``expired``), cancellation (``cancel()``, an abandoned
  ``stream_request()``; terminal ``cancelled``), admission control (a
  bounded queue and a queued-token budget: ``ServeRejectedError`` at
  ``submit()``), drain, and atomic snapshot/restore of every in-flight
  request (greedy recompute makes the continuation token-identical).

On a CUDA model the decode step is ONE ``torch.cuda.CUDAGraph`` per
engine, captured at the first decode over static device buffers for the
block tables, positions and tokens and over the persistent pools.  Each
iteration fills those buffers from pinned host arrays, replays the
graph, and reads the next tokens once: the loop's one device-to-host
sync.  ``trace_counts["decode"]`` counts captures.  There is no eager
decode on a CUDA model: a capture that fails raises.  Prefill runs
eagerly, padded to a pow2 bucket (``trace_counts["prefill_<b>"]``
counts the builds).  On a CPU model both run eagerly: the path the
tests take.

The graph holds the pools' addresses, so the engine never rebinds
``_kpools``/``_vpools``; ``restore()`` builds a fresh engine and so a
fresh capture.  The graph's outputs are rewritten by the next replay,
so nothing keeps a view into them (``keep_logits`` stores a copy).

Not in this slice: the telemetry counters, gauges and histograms, the
flight recorder and trace events, profiler lanes, fault injection
(``MXTPU_FAULT_SPEC``), the step watchdog (``step_timeout > 0`` raises),
``num_blocks="auto"`` (raises), ``perf_report`` and ``install_sigterm``.
"""
import os
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import resilience
from ..engine import get_env
from ..gluon.model_zoo.transformer import TransformerLM, _not_ported
from .block_table import BlockPool, BlockPoolExhausted
from .cache_manager import PrefixCache
from .quantize import quantize_weights
from .scheduler import (CANCELLED, EXPIRED, FAILED, FINISHED, QUEUED,
                        Request, RequestTooLargeError, Scheduler,
                        SchedulingError, ServeRejectedError)

__all__ = ["ServingEngine"]

SNAPSHOT_VERSION = 1
WARMUP_STEPS = 3        # eager decode steps on a side stream before capture

# the serving flags and their defaults, as the JAX package registers
# them (incubator_mxnet_tpu/utils/env.py)
_ENV = {
    "MXTPU_SERVE_BLOCK_SIZE": (int, 16),
    "MXTPU_SERVE_NUM_BLOCKS": (int, 512),
    "MXTPU_SERVE_MAX_BATCH": (int, 8),
    "MXTPU_SERVE_PREFIX_CACHE": (bool, True),
    "MXTPU_SERVE_QUANT": (str, "off"),
    "MXTPU_SERVE_TTFT_DEADLINE": (float, 0.0),
    "MXTPU_SERVE_DEADLINE": (float, 0.0),
    "MXTPU_SERVE_QUEUE_LIMIT": (int, 0),
    "MXTPU_SERVE_QUEUE_TOKENS": (int, 0),
    "MXTPU_SERVE_STEP_TIMEOUT": (float, 0.0),
}


def _env(name):
    """Flag ``name`` parsed as the JAX package's registry parses it: a
    missing or unparsable value gives the default."""
    type_, default = _ENV[name]
    raw = get_env(name)
    if raw is None:
        return default
    if type_ is bool:
        return raw not in ("0", "false", "False", "")
    try:
        return type_(raw)
    except ValueError:
        return default


def _next_pow2(n):
    return 1 << max(0, int(n - 1)).bit_length()


def _safe_list(seq, retries=4):
    """Copy a deque another thread may be appending to: iterating it
    during a concurrent append raises RuntimeError — retry, then
    degrade to empty rather than crash a monitoring caller."""
    for _ in range(retries):
        try:
            return list(seq)
        except RuntimeError:
            continue
    return []


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return type(tree)(_detached(v) for v in tree)


class ServingEngine:
    """Continuous-batching decode engine over one TransformerLM.

    Parameters (environment defaults in parentheses):

    model : an initialized TransformerLM (``attn_window`` must be 0);
        its device is the engine's
    max_batch : concurrent decode slots (``MXTPU_SERVE_MAX_BATCH``)
    block_size : tokens per KV block (``MXTPU_SERVE_BLOCK_SIZE``)
    num_blocks : pool size incl. the reserved scratch block
        (``MXTPU_SERVE_NUM_BLOCKS``); ``"auto"`` is not ported yet
    quantize : ``"off"`` or ``"int8"`` (``MXTPU_SERVE_QUANT``)
    prefix_cache : share prompt-prefix KV blocks across requests
        (``MXTPU_SERVE_PREFIX_CACHE``)
    keep_logits : keep each slot's last-step logits on the request (a
        copy on the model's device; for validation and debugging)
    ttft_deadline / deadline : default per-request SLOs in seconds
        (``MXTPU_SERVE_TTFT_DEADLINE`` / ``MXTPU_SERVE_DEADLINE``; 0
        disables); ``submit(..., ttft_deadline=, deadline=)`` overrides
        per request
    queue_limit / queue_tokens : admission control
        (``MXTPU_SERVE_QUEUE_LIMIT`` / ``MXTPU_SERVE_QUEUE_TOKENS``; 0 =
        unbounded): past either bound ``submit()`` sheds with a typed
        :class:`ServeRejectedError`
    step_timeout : the decode-step watchdog's budget
        (``MXTPU_SERVE_STEP_TIMEOUT``); only 0 (off) is ported

    Decoding is greedy, the mode whose outputs equal sequential
    ``generate()``.  ``submit()`` and ``cancel()`` may be called from
    any thread; ``step()``/``stream()``/``run()`` from one.
    """

    def __init__(self, model, max_batch=None, block_size=None,
                 num_blocks=None, quantize=None, prefix_cache=None,
                 keep_logits=False, ttft_deadline=None, deadline=None,
                 queue_limit=None, queue_tokens=None, step_timeout=None):
        if not isinstance(model, TransformerLM):
            raise TypeError(
                "ServingEngine serves TransformerLM models, got "
                f"{type(model).__name__}")
        model._check_paged()
        self.block_size = int(block_size if block_size is not None
                              else _env("MXTPU_SERVE_BLOCK_SIZE"))
        raw_blocks = num_blocks if num_blocks is not None \
            else _env("MXTPU_SERVE_NUM_BLOCKS")
        if isinstance(raw_blocks, str) and raw_blocks.lower() == "auto":
            raise _not_ported("num_blocks='auto' (pool sizing from the "
                              "memory planner and device_db)",
                              "operability")
        self.num_blocks = int(raw_blocks)
        self.max_batch = int(max_batch if max_batch is not None
                             else _env("MXTPU_SERVE_MAX_BATCH"))
        if self.block_size < 1 or self.max_batch < 1:
            raise ValueError(
                f"bad serving config: block_size={self.block_size}, "
                f"max_batch={self.max_batch}")
        quantize = _env("MXTPU_SERVE_QUANT") if quantize is None \
            else quantize
        if prefix_cache is None:
            prefix_cache = _env("MXTPU_SERVE_PREFIX_CACHE")
        self.ttft_deadline = float(
            ttft_deadline if ttft_deadline is not None
            else _env("MXTPU_SERVE_TTFT_DEADLINE"))
        self.deadline = float(deadline if deadline is not None
                              else _env("MXTPU_SERVE_DEADLINE"))
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else _env("MXTPU_SERVE_QUEUE_LIMIT"))
        self.queue_tokens = int(queue_tokens if queue_tokens is not None
                                else _env("MXTPU_SERVE_QUEUE_TOKENS"))
        self.step_timeout = float(
            step_timeout if step_timeout is not None
            else _env("MXTPU_SERVE_STEP_TIMEOUT"))
        if self.step_timeout > 0:
            raise _not_ported("step_timeout > 0 (the decode-step "
                              "watchdog and its flight-recorder dump)",
                              "operability")

        self.model = model
        self.device = model.device
        # one table row spans the model's full context budget
        self.max_blocks = -(-model._max_len // self.block_size)
        self._sched = Scheduler(self.max_batch)
        self.keep_logits = bool(keep_logits)

        wts = _detached(model._decode_params())
        if quantize in ("int8", True):
            self._wts = quantize_weights(wts)
            self.quantized = True
        elif quantize in ("off", "", False, None):
            self._wts = wts
            self.quantized = False
        else:
            raise ValueError(
                f"quantize must be 'off' or 'int8', got {quantize!r}")
        if self.num_blocks < 1:
            raise ValueError(
                f"bad serving config: num_blocks={self.num_blocks}")
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.cache = PrefixCache(self.pool, enabled=prefix_cache)
        kvh = model.n_kv_heads
        shape = (self.num_blocks, self.block_size, kvh,
                 model._d // model.n_heads)
        # zeros, never empty: masked lanes multiply 0 * v, and NaN
        # garbage in a never-written block would poison every slot.
        # Bound once: the captured graph holds these addresses.
        self._kpools = [torch.zeros(shape, device=self.device)
                        for _ in range(model.n_layers)]
        self._vpools = [torch.zeros(shape, device=self.device)
                        for _ in range(model.n_layers)]

        B, MB = self.max_batch, self.max_blocks
        cuda = self.device.type == "cuda"
        # the decode step's inputs: host arrays (pinned on a CUDA
        # model, so their copies are asynchronous), and on a CUDA model
        # the static device buffers the captured graph reads
        host = [torch.zeros(s, dtype=torch.int64) for s in
                ((B, MB), (B,), (B,))]
        if cuda:
            host = [t.pin_memory() for t in host]
            self._static_in = [torch.zeros_like(t, device=self.device)
                               for t in host]
        self._host_in = host
        self._host_np = [t.numpy() for t in host]
        self._graph = None
        self._graph_out = None

        self._step_fn = None
        self._prefill_fns = {}
        self.trace_counts = {}
        self._next_id = 0
        self._submit_lock = threading.Lock()
        self._completed = []        # terminal since last run()/drain()
        # live requests by id (cancel() target), terminal-state counts
        # for stats(), the drain latch, and two arm counters that keep
        # the reap sweep off the decode hot path when no deadline or
        # cancel is pending
        self._live = {}
        self._terminal_counts = {}
        self._draining = False
        self._deadlines_armed = 0
        self._cancels_pending = 0
        # earliest armed deadline stamp: the reap sweep skips the queue
        # walk until the clock reaches it (or a cancel is pending)
        self._deadline_next = float("inf")
        # the one request mid-transit between queue and slot (_admit
        # pop->place, _preempt clear->requeue): a snapshot taken in that
        # window must still see it
        self._in_transit = None
        # lock-free dirty bit for stream_request abandons: set with a
        # plain store from whatever thread GC runs the finalizer on
        self._abandon_flagged = False
        self._req_summaries = deque(maxlen=1024)
        self.prefix_hit_tokens = 0     # prompt tokens the cache served

    # ---------------------------------------------------------- setup
    def _get_step_fn(self):
        if self._step_fn is None:
            self._step_fn = self.model._build_paged_step(
                self.max_batch, self.max_blocks, self.block_size)
            if self.device.type != "cuda":
                # the eager step's one build (on the card, captures count)
                self.trace_counts["decode"] = \
                    self.trace_counts.get("decode", 0) + 1
        return self._step_fn

    def _get_prefill_fn(self, suffix_len):
        # pow2 buckets, floored at one block: a prefix-cache hit can
        # shrink the suffix to a couple of tokens
        bucket = min(max(_next_pow2(suffix_len),
                         _next_pow2(self.block_size)),
                     _next_pow2(self.model._max_len))
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._prefill_fns[bucket] = \
                self.model._build_paged_prefill(bucket, self.max_blocks,
                                                self.block_size)
            name = f"prefill_{bucket}"
            self.trace_counts[name] = self.trace_counts.get(name, 0) + 1
        return bucket, fn

    def _capture(self):
        """Capture the decode step as one CUDA graph over the static
        input buffers and the pools.  The warm-up steps run on a side
        stream with every slot inactive (the buffers are zero), so
        their writes land in the scratch block only."""
        fn = self._get_step_fn()
        args = (self._wts, self._kpools, self._vpools, *self._static_in)
        with torch.cuda.device(self.device):
            for t in self._static_in:
                t.zero_()
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side), torch.no_grad():
                for _ in range(WARMUP_STEPS):
                    fn(*args)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(graph):
                out = fn(*args)
        self._graph, self._graph_out = graph, out
        self.trace_counts["decode"] = self.trace_counts.get("decode", 0) + 1

    def _run_step(self):
        """The decode step on the inputs in the host arrays: replay of
        the captured graph on a CUDA model, an eager call on a CPU one.
        Returns (next_tokens, logits) on the model's device; on the card
        they are the graph's static outputs, rewritten by the next
        replay."""
        if self.device.type != "cuda":
            with torch.no_grad():
                return self._get_step_fn()(self._wts, self._kpools,
                                           self._vpools, *self._host_in)
        if self._graph is None:
            self._capture()
        for dev, host in zip(self._static_in, self._host_in):
            dev.copy_(host, non_blocking=True)
        self._graph.replay()
        return self._graph_out

    # ------------------------------------------------------------- API
    def _check_servable(self, n_tokens, max_new):
        """Raise :class:`RequestTooLargeError` when a request of
        ``n_tokens`` prompt + ``max_new`` generated tokens can NEVER be
        served by this engine — queueing it would hang the schedule."""
        total = n_tokens + max_new
        if total > self.model._max_len:
            raise RequestTooLargeError(
                f"prompt+new = {total} exceeds max_len "
                f"{self.model._max_len}")
        need = -(-total // self.block_size)
        if need > min(self.max_blocks, self.pool.capacity):
            raise RequestTooLargeError(
                f"request needs {need} blocks but the pool serves "
                f"at most {min(self.max_blocks, self.pool.capacity)}"
                " per sequence — raise MXTPU_SERVE_NUM_BLOCKS or "
                "shrink the request")

    def _reject(self, n_tokens, reason):
        """Shed one submission: count it, then raise typed."""
        depth = len(self._sched.waiting)
        qtok = self._sched.queued_tokens
        self._terminal_counts["rejected"] = \
            self._terminal_counts.get("rejected", 0) + 1
        raise ServeRejectedError(
            f"request rejected ({reason}): queue depth {depth}"
            f"/{self.queue_limit or 'inf'}, queued tokens {qtok}"
            f"/{self.queue_tokens or 'inf'} — shedding keeps "
            "admitted requests' latency bounded")

    def submit(self, tokens, max_new_tokens, eos_id=None,
               ttft_deadline=None, deadline=None):
        """Enqueue a prompt; returns its :class:`Request` handle.

        ``tokens`` is a 1-D int sequence (list, numpy array, tensor or
        NDArray).  The handle's ``generated`` list fills as the engine
        runs (drive it via :meth:`step`, :meth:`stream` or :meth:`run`).

        ``ttft_deadline`` / ``deadline`` (seconds; default the engine's,
        0/None = none) bound first token and total completion: a request
        past either expires (state ``expired``, blocks freed).  Raises
        :class:`RequestTooLargeError` when the request can never fit the
        pool or context, and :class:`ServeRejectedError` when admission
        control sheds it (bounded queue, token budget, or draining)."""
        if hasattr(tokens, "asnumpy"):
            tokens = tokens.asnumpy()
        elif isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        toks = [int(t) for t in np.asarray(tokens).ravel()]
        max_new = int(max_new_tokens)
        if not toks:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {max_new})")
        self._check_servable(len(toks), max_new)
        if ttft_deadline is None:
            ttft_deadline = self.ttft_deadline
        if deadline is None:
            deadline = self.deadline
        with self._submit_lock:     # submit() may race across threads
            # admission control: shed at the door.  Preemption requeues
            # bypass this (push_front): they were already admitted.
            if self._draining:
                self._reject(len(toks), "draining")
            if self.queue_limit > 0 and \
                    len(self._sched.waiting) >= self.queue_limit:
                self._reject(len(toks), "queue_limit")
            if self.queue_tokens > 0 and \
                    self._sched.queued_tokens + len(toks) \
                    > self.queue_tokens:
                self._reject(len(toks), "queue_tokens")
            req = Request(self._next_id, toks, max_new, eos_id=eos_id)
            self._next_id += 1
            now = time.monotonic()
            if ttft_deadline and ttft_deadline > 0:
                req.ttft_deadline_ts = now + float(ttft_deadline)
            if deadline and deadline > 0:
                req.deadline_ts = now + float(deadline)
            if req.ttft_deadline_ts is not None \
                    or req.deadline_ts is not None:
                self._deadlines_armed += 1
                self._deadline_next = min(self._deadline_next,
                                          self._next_deadline(req))
            self._live[req.id] = req
            self._sched.add(req)
        return req

    def cancel(self, rid):
        """Request cancellation of a live request by id (thread-safe).
        Honored at the next engine iteration: the request reaches
        terminal state ``cancelled`` with its partial output retained
        and every pool block freed.  Returns True when the request was
        live and is now marked; False when unknown or already
        terminal."""
        with self._submit_lock:
            req = self._live.get(rid)
            if req is None or req.done or req.cancel_requested:
                return False
            req.cancel_requested = True
            req.cancel_counted = True
            self._cancels_pending += 1
            return True

    def has_work(self):
        """Whether driving the engine can still make progress: any
        request queued or running — or, while draining, only the
        RUNNING batch (queued requests are frozen for
        :meth:`snapshot`)."""
        return self._has_loop_work()

    def _has_loop_work(self):
        if self._draining:
            return self._sched.any_running()
        return self._sched.has_work()

    def step(self):
        """One continuous-batching iteration: reap (cancellations and
        expired deadlines, blocks freed the same iteration) -> admit ->
        grow -> decode -> retire.  Returns the ``(request, token_id)``
        events emitted this iteration."""
        events = []
        self._reap()
        self._admit(events)
        if self._sched.any_running():
            self._grow()
        if self._sched.any_running():
            self._decode_once(events)
        return events

    def stream(self):
        """Drive the engine, yielding ``(request, token_id)`` events as
        they are produced, until all submitted work drains (or, while
        draining, until the running batch finishes)."""
        while self._has_loop_work():
            yield from self.step()

    def stream_request(self, req):
        """Drive the engine yielding ``req``'s tokens only — the
        per-client streaming view.  ABANDONING the generator (break /
        ``close()`` / GC — started or not) cancels the request.  The
        abandon path only FLAGS the cancellation, with plain attribute
        stores (a GC finalizer may run it on any thread, even inside
        ``step()``), and the next engine iteration finalizes it as
        CANCELLED.  A NORMAL exit (the request finished, or drain
        latched and the loop ran out of work) cancels nothing."""
        # a shared cell: a generator abandoned before its first next()
        # never runs its body, so the finalizer on the generator object
        # covers that case, and the cell tells it a normal exhaustion
        # already happened
        state = {"exhausted": False}

        def _flag():
            if not state["exhausted"] and not req.done:
                req.cancel_requested = True
                self._abandon_flagged = True

        gen = self._stream_gen(req, state, _flag)
        weakref.finalize(gen, _flag)
        return gen

    def _stream_gen(self, req, state, flag):
        # a cursor over req.generated, not this generator's own step()
        # events: other drivers may decode this request's tokens
        sent = 0
        try:
            while True:
                while sent < len(req.generated):
                    yield req.generated[sent]
                    sent += 1
                if req.done or not self._has_loop_work():
                    break
                self.step()
            state["exhausted"] = True
        finally:
            flag()

    def run(self):
        """Drain everything; returns ``{request_id: full token list}``
        for every request that reached a terminal state during this call
        (failed, expired and cancelled ones with their partial output —
        check ``request.state``)."""
        for _ev in self.stream():
            pass
        done, self._completed = self._completed, []
        return {req.id: req.tokens for req in done}

    def drain(self, run=True):
        """Graceful shutdown, phase one: stop admission (later
        ``submit()`` calls shed with ``ServeRejectedError``), keep queued
        requests queued — they belong to :meth:`snapshot` — and, with
        ``run=True``, finish the RUNNING batch.  Returns the terminal
        requests collected since the last ``run()``/``drain()`` as
        ``{id: tokens}``.  Idempotent."""
        self._draining = True
        if run:
            while self._sched.any_running():
                self.step()
        done, self._completed = self._completed, []
        return {req.id: req.tokens for req in done}

    # -------------------------------------------- snapshot / restore
    def _snapshot_request(self, req, now):
        """One in-flight request's resumable state.  Deadlines are kept
        as REMAINING seconds (monotonic stamps mean nothing in another
        process); a negative remainder expires the restored request on
        its first iteration."""
        wait = req.queue_wait_s
        if req.state == QUEUED:
            wait += now - req.enqueue_ts
        return {
            "id": req.id,
            "prompt": list(req.prompt),
            "generated": list(req.generated),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id,
            "queue_wait_s": wait,
            "prefill_s": req.prefill_s,
            "preemptions": req.preemptions,
            "ttft_done": req.first_token_ts is not None,
            "ttft_remaining_s": (
                req.ttft_deadline_ts - now
                if req.ttft_deadline_ts is not None else None),
            "deadline_remaining_s": (
                req.deadline_ts - now
                if req.deadline_ts is not None else None),
        }

    def snapshot(self, path=None):
        """Persist every in-flight request (running by admission order
        first, then the waiting queue in order) so a fresh engine can
        :meth:`restore` them: greedy recompute from prompt + generated
        makes the continuation token-identical.

        Returns the snapshot dict; with ``path`` it is also written via
        ``resilience.atomic_save`` (+ CRC32 sidecar), as a pickle of the
        same dict the JAX package writes, so either package restores the
        other's file.  Reads host state only; a request caught
        mid-transit between queue and slot (``_in_transit``) is
        captured too."""
        now = time.monotonic()
        running = sorted(
            (r for r in list(self._sched.slots) if r is not None),
            key=lambda r: r.admit_seq)
        transit = self._in_transit
        # index walk: client threads only APPEND to the waiting deque,
        # so this yields a consistent view where an iterator would
        # raise on a concurrent append
        waiting = []
        i = 0
        while True:
            try:
                waiting.append(self._sched.waiting[i])
            except IndexError:
                break
            i += 1
        # cancel-flagged requests are excluded (the client hung up); the
        # id dedup covers a transit pointer that already landed, and
        # _live catches any request the three views missed
        reqs, seen = [], set()
        for r in (list(running)
                  + ([transit] if transit is not None else [])
                  + waiting
                  + list(self._live.copy().values())):
            if r.id in seen or r.done or r.cancel_requested:
                continue
            seen.add(r.id)
            reqs.append(self._snapshot_request(r, now))
        snap = {
            "version": SNAPSHOT_VERSION,
            "engine": {"max_batch": self.max_batch,
                       "block_size": self.block_size,
                       "num_blocks": self.num_blocks,
                       "prefix_cache": self.cache.enabled,
                       "quantize": "int8" if self.quantized else "off",
                       "max_len": self.model._max_len},
            "next_id": self._next_id,
            "requests": reqs,
        }
        if path is not None:
            import pickle
            resilience.atomic_save(path, lambda f: pickle.dump(snap, f))
        return snap

    @classmethod
    def restore(cls, model, snapshot, **engine_kw):
        """Build a fresh engine and re-queue every request of a
        :meth:`snapshot` (a path, or the dict itself).  Restored
        requests continue by greedy recompute, so completed outputs are
        token-identical to an uninterrupted run.  Engine geometry
        defaults to the snapshot's; explicit ``engine_kw`` overrides
        win, and a request the new geometry can never serve fails
        loudly at admission (typed, per request)."""
        if isinstance(snapshot, (str, os.PathLike)):
            import pickle
            path = os.fspath(snapshot)
            snapshot = resilience.decode_or_corrupt(
                path, lambda: pickle.loads(
                    resilience.read_validated_bytes(path)))
        if not isinstance(snapshot, dict) or \
                snapshot.get("version") != SNAPSHOT_VERSION or \
                "requests" not in snapshot:
            raise resilience.CheckpointCorruptError(
                "not a serving snapshot (or an incompatible "
                f"version): {snapshot!r:.80}")
        cfg = snapshot.get("engine", {})
        for key in ("max_batch", "block_size", "num_blocks",
                    "prefix_cache", "quantize"):
            if cfg.get(key) is not None:
                engine_kw.setdefault(key, cfg[key])
        eng = cls(model, **engine_kw)
        for entry in snapshot["requests"]:
            eng.resubmit(entry)
        with eng._submit_lock:
            eng._next_id = max(eng._next_id,
                               int(snapshot.get("next_id", 0)))
        return eng

    def resubmit(self, entry):
        """Re-admit ONE request in :meth:`_snapshot_request` entry form
        (the re-admission path under :meth:`restore`).  Continues by
        greedy recompute.  Bypasses admission control: the request was
        already admitted once.  Deadlines in the entry are REMAINING
        seconds, re-armed against this process's monotonic clock; a
        request whose first token already shipped (``ttft_done``) does
        not re-arm its TTFT.  Returns the :class:`Request`."""
        now = time.monotonic()
        complete = False   # retired OUTSIDE the lock: _finalize takes it
        with self._submit_lock:
            req = Request(int(entry["id"]), entry["prompt"],
                          entry["max_new_tokens"],
                          eos_id=entry.get("eos_id"))
            req.generated = [int(t) for t in entry.get("generated", [])]
            req.queue_wait_s = float(entry.get("queue_wait_s", 0.0))
            req.prefill_s = float(entry.get("prefill_s", 0.0))
            req.preemptions = int(entry.get("preemptions", 0))
            rem = entry.get("deadline_remaining_s")
            if rem is not None:
                req.deadline_ts = now + float(rem)
            rem = entry.get("ttft_remaining_s")
            if entry.get("ttft_done"):
                req.first_token_ts = now
                req.last_token_ts = now
            elif rem is not None:
                req.ttft_deadline_ts = now + float(rem)
            self._live[req.id] = req
            self._next_id = max(self._next_id, req.id + 1)
            # a snapshot can catch a request BETWEEN its last generated
            # token and its same-iteration retirement: it is complete,
            # and re-queueing it would decode one token past its budget
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and req.generated
                        and req.generated[-1] == req.eos_id)):
                complete = True
            else:
                if req.ttft_deadline_ts is not None \
                        or req.deadline_ts is not None:
                    self._deadlines_armed += 1
                    self._deadline_next = min(self._deadline_next,
                                              self._next_deadline(req))
                self._sched.add(req)
        if complete:
            self._retire(req)
        return req

    def take_completed(self):
        """Pop and return the terminal :class:`Request` objects collected
        since the last ``run()``/``drain()``/``take_completed()``,
        without latching drain."""
        with self._submit_lock:
            done, self._completed = self._completed, []
        return done

    # ------------------------------------------------------ internals
    def _alloc(self, n):
        """Pool alloc with prefix-cache eviction as the fallback."""
        try:
            return self.pool.alloc(n)
        except BlockPoolExhausted:
            self.cache.evict(n - self.pool.num_free)
            return self.pool.alloc(n)       # may re-raise

    def _admit(self, events):
        """Fill free slots from the waiting queue; one suffix prefill
        per admission (prefix-cache hits skip the shared blocks)."""
        if self._draining:
            return      # drain(): queued requests belong to snapshot()
        while self._sched.has_waiting():
            slot = self._sched.free_slot()
            if slot is None:
                return
            # publish to the snapshot pointer BEFORE popping
            self._in_transit = self._sched.waiting[0]
            req = self._sched.pop_waiting()
            try:
                # re-check at admission: a snapshot restored into a
                # smaller pool/context must fail THAT request loudly
                self._check_servable(len(req.prompt), req.max_new_tokens)
            except RequestTooLargeError as exc:
                self._fail(req, exc)
                continue
            toks = req.tokens
            matched, n_cached = self.cache.match(toks)
            need = -(-len(toks) // self.block_size) - len(matched)
            try:
                fresh = self._alloc(need)
            except BlockPoolExhausted:
                if matched:
                    self.pool.free(matched)     # release the match
                self._sched.push_front(req)
                self._in_transit = None
                if not self._sched.any_running():
                    raise SchedulingError(
                        f"request {req.id} needs {need} fresh "
                        "blocks but the pool cannot ever provide "
                        "them — raise MXTPU_SERVE_NUM_BLOCKS")
                return                          # wait for frees
            req.admit_ts = time.monotonic()
            # per-segment wait: a preempted request's requeue restarted
            # the clock
            req.queue_wait_s += req.admit_ts - req.enqueue_ts
            self.prefix_hit_tokens += n_cached
            req.block_ids = matched + fresh
            self._sched.place(req, slot)
            self._in_transit = None

            suffix = toks[n_cached:]
            bucket, fn = self._get_prefill_fn(len(suffix))
            suf = np.zeros(bucket, np.int64)
            suf[:len(suffix)] = suffix
            row = np.zeros(self.max_blocks, np.int64)
            row[:len(req.block_ids)] = req.block_ids
            t_pre = time.monotonic()
            with torch.no_grad():
                nxt, logits = fn(
                    self._wts, self._kpools, self._vpools,
                    torch.as_tensor(row, device=self.device), n_cached,
                    torch.as_tensor(suf, device=self.device),
                    len(suffix))
                tok = int(nxt)      # the first-token read seeds decode
            req.prefill_s += time.monotonic() - t_pre
            if self.keep_logits:
                req.logits = logits
            # register this stream's full blocks for future sharing
            self.cache.insert(toks, req.block_ids)
            req.n_past = len(toks)
            self._append_token(req, tok, events)

    def _grow(self):
        """Ensure every runner owns the block its next position writes
        into; preempt the latest-admitted runner on exhaustion."""
        bs = self.block_size
        for req in sorted(self._sched.running(),
                          key=lambda r: r.admit_seq):
            if req.done or req.slot is None:
                continue        # preempted earlier in this pass
            if req.n_past // bs < len(req.block_ids):
                continue
            while True:
                try:
                    req.block_ids += self._alloc(1)
                    break
                except BlockPoolExhausted:
                    victim = self._sched.latest_running()
                    if victim is req and self._sched.n_running() == 1:
                        # the pool cannot hold this one sequence: fail
                        # THE REQUEST loudly instead of spinning
                        self._fail(req, SchedulingError(
                            "block pool exhausted with a single "
                            "running request — the pool cannot hold "
                            "one full sequence; raise "
                            "MXTPU_SERVE_NUM_BLOCKS"))
                        break
                    self._preempt(victim)
                    if victim is req:
                        break               # we preempted ourselves

    def _preempt(self, req):
        """Free a runner's blocks and re-queue it (front).  Its generated
        tokens survive; re-admission re-prefills prompt+generated."""
        self._in_transit = req      # out of the slot, not yet queued
        self._sched.clear(req)
        if req.block_ids:
            self.pool.free(req.block_ids)
        req.block_ids = []
        req.n_past = 0
        req.state = QUEUED
        req.preemptions += 1
        req.enqueue_ts = time.monotonic()
        self._sched.push_front(req)
        self._in_transit = None

    def _fill_decode_inputs(self):
        """Write every slot's newest token, position and block-table row
        into the host arrays; inactive slots stay all zero (the scratch
        block at position 0)."""
        tables, npast, tokens = self._host_np
        tables.fill(0)
        npast.fill(0)
        tokens.fill(0)
        for i, req in enumerate(self._sched.slots):
            if req is None:
                continue
            tokens[i] = req.generated[-1]
            npast[i] = req.n_past
            tables[i, :len(req.block_ids)] = req.block_ids

    def _decode_once(self, events):
        """One batched decode step and the per-iteration token read."""
        self._fill_decode_inputs()
        nxt, logits = self._run_step()
        toks = nxt.tolist()     # the iteration's one device-to-host sync
        for i, req in enumerate(list(self._sched.slots)):
            if req is None:
                continue
            req.n_past += 1
            if self.keep_logits:
                # a copy: the graph's output is rewritten by the next
                # replay
                req.logits = logits[i].clone()
            self._append_token(req, int(toks[i]), events)

    def _append_token(self, req, tok, events):
        """Record one emitted token; retire the request when its budget
        or EOS is reached."""
        now = time.monotonic()
        if req.first_token_ts is None:
            req.first_token_ts = now
        req.last_token_ts = now
        req.generated.append(tok)
        events.append((req, tok))
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._retire(req)

    # ----------------------------------------------- terminal paths
    def _release(self, req, now):
        """Shared terminal release: the open queue-wait segment closed,
        the slot cleared and every pool block freed in the SAME
        iteration the terminal was decided."""
        if req.state == QUEUED:
            req.queue_wait_s += now - req.enqueue_ts
        self._sched.clear(req)
        if req.block_ids:
            self.pool.free(req.block_ids)
        req.block_ids = []
        req.finish_ts = now

    def _finalize(self, req):
        """Terminal bookkeeping every exit path funnels through: exactly
        one summary, one completed entry, one per-state count, and the
        reap arm counters released."""
        with self._submit_lock:
            self._live.pop(req.id, None)
            # release only counts cancel() actually took: the
            # stream-abandon flag never bumps the counter
            if req.cancel_counted and self._cancels_pending > 0:
                self._cancels_pending -= 1
            if (req.ttft_deadline_ts is not None
                    or req.deadline_ts is not None) \
                    and self._deadlines_armed > 0:
                self._deadlines_armed -= 1
            self._terminal_counts[req.state] = \
                self._terminal_counts.get(req.state, 0) + 1
        self._completed.append(req)
        self._req_summaries.append(self._request_summary(req))

    def _retire(self, req):
        self._release(req, time.monotonic())
        req.state = FINISHED
        self._finalize(req)

    def _fail(self, req, exc):
        """Evict an unservable request without touching batchmates."""
        self._release(req, time.monotonic())
        req.state = FAILED
        req.error = exc
        self._finalize(req)

    def _expire(self, req, why, now):
        """Terminal ``expired``: the request's TTFT or total deadline
        passed.  Partial output is retained on the handle; ``req.error``
        carries a typed DeadlineExceededError."""
        self._release(req, now)
        req.state = EXPIRED
        req.error = resilience.DeadlineExceededError(
            f"serving request {req.id} missed its {why} deadline "
            f"after {len(req.generated)} generated token(s)")
        self._finalize(req)

    def _cancel_now(self, req, now):
        """Terminal ``cancelled``: partial output retained, blocks
        freed this iteration."""
        self._release(req, now)
        req.state = CANCELLED
        self._finalize(req)

    @staticmethod
    def _verdict(req, now):
        """Why a live request must leave the engine now, or None.
        Cancellation wins over expiry; the TTFT deadline only binds
        before the first token."""
        if req.cancel_requested:
            return "cancel"
        if req.deadline_ts is not None and now >= req.deadline_ts:
            return "total"
        if req.first_token_ts is None \
                and req.ttft_deadline_ts is not None \
                and now >= req.ttft_deadline_ts:
            return "ttft"
        return None

    @staticmethod
    def _next_deadline(req):
        """Earliest future stamp at which ``req`` could expire, or +inf
        (a stale TTFT stamp only makes the next sweep fire early)."""
        nxt = float("inf")
        if req.deadline_ts is not None:
            nxt = req.deadline_ts
        if req.first_token_ts is None \
                and req.ttft_deadline_ts is not None:
            nxt = min(nxt, req.ttft_deadline_ts)
        return nxt

    def _reap(self):
        """Honor pending cancellations and blown deadlines — queued and
        running alike — freeing blocks and slots in the same iteration.
        The arm counters and the earliest-deadline stamp keep this to an
        integer test (and a clock read) on the decode hot path.  Queued
        requests are REMOVED in place, never popped and re-pushed."""
        flagged = self._abandon_flagged
        if not (self._cancels_pending or flagged
                or self._deadlines_armed):
            return
        now = time.monotonic()
        if not (self._cancels_pending or flagged) \
                and now < self._deadline_next:
            return
        self._abandon_flagged = False
        with self._submit_lock:
            self._deadline_next = float("inf")
        nxt = float("inf")
        for req in _safe_list(self._sched.waiting):
            why = self._verdict(req, now)
            if why is None:
                nxt = min(nxt, self._next_deadline(req))
                continue
            with self._submit_lock:
                removed = self._sched.remove_waiting(req)
            if removed:
                if why == "cancel":
                    self._cancel_now(req, now)
                else:
                    self._expire(req, why, now)
        for req in list(self._sched.slots):
            if req is None:
                continue
            why = self._verdict(req, now)
            if why == "cancel":
                self._cancel_now(req, now)
            elif why is not None:
                self._expire(req, why, now)
            else:
                nxt = min(nxt, self._next_deadline(req))
        with self._submit_lock:
            self._deadline_next = min(self._deadline_next, nxt)

    # -------------------------------------------------- observability
    @staticmethod
    def _request_summary(req):
        """One request's TTFT decomposition for :meth:`stats`."""
        ttft = (req.first_token_ts - req.submit_ts
                if req.first_token_ts is not None else None)
        decode = (req.last_token_ts - req.first_token_ts
                  if req.first_token_ts is not None
                  and req.last_token_ts is not None else None)
        return {
            "id": req.id, "state": req.state,
            "prompt_tokens": len(req.prompt),
            "tokens_generated": len(req.generated),
            "preemptions": req.preemptions,
            "queue_wait_s": round(req.queue_wait_s, 6),
            "prefill_s": round(req.prefill_s, 6),
            "ttft_s": round(ttft, 6) if ttft is not None else None,
            "decode_s": (round(decode, 6)
                         if decode is not None else None),
            "error": str(req.error) if req.error is not None else None,
        }

    def stats(self):
        """Engine snapshot: per-request lifecycle summaries (the last
        1024 terminal requests, and the live ones), trace counts and
        pool state.  Host bookkeeping only, no device access."""
        live = [self._request_summary(r)
                for r in _safe_list(self._sched.waiting)
                + self._sched.running()]
        return {
            "requests": _safe_list(self._req_summaries),
            "live": live,
            "trace_counts": dict(self.trace_counts),
            "batch_occupancy": self._sched.n_running() / self.max_batch,
            "pool_utilization": self.pool.utilization(),
            "terminal_counts": dict(self._terminal_counts),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "queue_depth": len(self._sched.waiting),
            "queued_tokens": self._sched.queued_tokens,
            "draining": self._draining,
        }
