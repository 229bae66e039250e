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
  ``submit()``), drain, atomic snapshot/restore of every in-flight
  request (greedy recompute makes the continuation token-identical),
  SIGTERM wired to snapshot-then-drain (``install_sigterm``), and a
  decode-step watchdog that dumps the flight recorder on budget
  overruns.  ``MXTPU_FAULT_SPEC`` scopes ``serve:step`` /
  ``serve:deadline`` / ``serve:queue`` / ``serve:request`` inject
  faults on each of those paths.
- **Operability**: the process telemetry registry (request and token
  counters, queue-wait / TTFT / per-token histograms, occupancy, pool
  and queue gauges, ``serving_mfu``), the flight recorder's
  ``serve_*`` events keyed by ``(engine, rid)``, the compile ledger,
  the ``kv_pools`` memory provider, and the profiler's serving lanes.
  ``num_blocks="auto"`` sizes the pool from the memory planner's
  headroom; ``perf_report()`` is the analytic roofline of one decode
  step.

On a CUDA model the decode step is ONE ``torch.cuda.CUDAGraph`` per
engine, captured at the first decode over static device buffers for the
block tables, positions and tokens and over the persistent pools.  Each
iteration fills those buffers from pinned host arrays, replays the
graph, and reads the next tokens once: the loop's one device-to-host
sync.  ``trace_counts["decode"]`` counts captures.  There is no eager
decode on a CUDA model: a capture that fails raises.  Prefill runs
eagerly, padded to a pow2 bucket (``trace_counts["prefill_<b>"]``
counts the builds).  On a CPU model both run eagerly: the path the
tests take.  Every hook runs on the host, outside the capture, and
reads host state only (counts, context lengths, the pool's free list).

The graph holds the pools' addresses, so the engine never rebinds
``_kpools``/``_vpools`` (and ``num_blocks="auto"`` settles before they
are allocated); ``restore()`` builds a fresh engine and so a fresh
capture.  The graph's outputs are rewritten by the next replay, so
nothing keeps a view into them (``keep_logits`` stores a copy).
"""
import itertools
import os
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import resilience, telemetry, tracing
from ..utils.env import get_env
from ..utils.log import get_logger
from ..gluon.model_zoo.transformer import TransformerLM
from .block_table import BlockPool, BlockPoolExhausted
from .cache_manager import PrefixCache
from .quantize import quantize_weights
from .scheduler import (CANCELLED, EXPIRED, FAILED, FINISHED, QUEUED,
                        Request, RequestTooLargeError, Scheduler,
                        SchedulingError, ServeRejectedError)

__all__ = ["ServingEngine"]

SNAPSHOT_VERSION = 1
WARMUP_STEPS = 3        # eager decode steps on a side stream before capture

# process-unique engine ids: request ids restart at 0 per engine, so
# trace events carry (engine, rid) — a post-mortem dump spanning two
# engines must never conflate their requests
_ENGINE_IDS = itertools.count()

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def _next_pow2(n):
    return 1 << max(0, int(n - 1)).bit_length()


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
        (``MXTPU_SERVE_NUM_BLOCKS``); ``"auto"`` sizes the pool from the
        memory planner's headroom — the device's capacity
        (``MXTPU_HBM_BYTES`` overrides it) minus the weights and a decode
        workspace — and raises a typed ``MemoryPlanError`` when the
        model alone leaves no room for one block per slot
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
    step_timeout : the decode-step watchdog's budget in seconds
        (``MXTPU_SERVE_STEP_TIMEOUT``; 0 disables)

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
                              else get_env("MXTPU_SERVE_BLOCK_SIZE"))
        raw_blocks = num_blocks if num_blocks is not None \
            else get_env("MXTPU_SERVE_NUM_BLOCKS")
        # num_blocks="auto": size the pool from planner headroom once
        # the weights are settled below
        self.auto_blocks = (isinstance(raw_blocks, str)
                            and raw_blocks.lower() == "auto")
        self.num_blocks = 0 if self.auto_blocks else int(raw_blocks)
        self.max_batch = int(max_batch if max_batch is not None
                             else get_env("MXTPU_SERVE_MAX_BATCH"))
        if self.block_size < 1 or self.max_batch < 1:
            raise ValueError(
                f"bad serving config: block_size={self.block_size}, "
                f"max_batch={self.max_batch}")
        quantize = get_env("MXTPU_SERVE_QUANT") if quantize is None \
            else quantize
        if prefix_cache is None:
            prefix_cache = get_env("MXTPU_SERVE_PREFIX_CACHE")
        # every deadline comparison is on the monotonic clock: wall
        # clock jumps must never expire work
        self.ttft_deadline = float(
            ttft_deadline if ttft_deadline is not None
            else get_env("MXTPU_SERVE_TTFT_DEADLINE"))
        self.deadline = float(deadline if deadline is not None
                              else get_env("MXTPU_SERVE_DEADLINE"))
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else get_env("MXTPU_SERVE_QUEUE_LIMIT"))
        self.queue_tokens = int(queue_tokens if queue_tokens is not None
                                else get_env("MXTPU_SERVE_QUEUE_TOKENS"))
        self.step_timeout = float(
            step_timeout if step_timeout is not None
            else get_env("MXTPU_SERVE_STEP_TIMEOUT"))

        self.model = model
        self.device = model.device
        # one table row spans the model's full context budget
        self.max_blocks = -(-model._max_len // self.block_size)
        self._sched = Scheduler(self.max_batch)
        self.keep_logits = bool(keep_logits)

        # weights settle BEFORE the pool: auto pool sizing needs the
        # real (possibly quantized) weight bytes on the device
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
        kvh = model.n_kv_heads
        dh = model._d // model.n_heads
        self.memory_plan = None     # the auto pool's accepted plan
        if self.auto_blocks:
            self.num_blocks = self._auto_num_blocks(kvh, dh)
        if self.num_blocks < 1:
            raise ValueError(
                f"bad serving config: num_blocks={self.num_blocks}")
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.cache = PrefixCache(self.pool, enabled=prefix_cache)
        shape = (self.num_blocks, self.block_size, kvh, dh)
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
        # pop->place, _preempt clear->requeue): a SIGTERM snapshot
        # taken in that window must still see it
        self._in_transit = None
        # lock-free dirty bit for stream_request abandons: set with a
        # plain store from whatever thread GC runs the finalizer on
        self._abandon_flagged = False
        self.prefix_hit_tokens = 0     # prompt tokens the cache served
        # flight recorder: compile attribution for the builders,
        # terminal per-request summaries for stats(), and the KV pools'
        # bytes attributed in the device-memory gauges (through a
        # weakref, so the process-wide provider table never pins a
        # dropped engine)
        self.engine_id = next(_ENGINE_IDS)
        # per-engine ledger site: each engine builds (and captures) its
        # own steps, so a shared site would call the second 'duplicate'
        self._ledger = tracing.compile_ledger(
            f"serving_engine:{self.engine_id}")
        self._req_summaries = deque(maxlen=1024)
        # serving lanes are static: named once, not per async event
        from .. import profiler
        profiler._profiler.set_lane_name(
            profiler.SERVE_QUEUE_LANE, "serve queue")
        for s in range(self.max_batch):
            profiler._profiler.set_lane_name(
                profiler.SERVE_SLOT_LANE0 + s, f"serve slot {s}")
        ref = weakref.ref(self)

        def _kv_arrays():
            eng = ref()
            if eng is None:
                return []
            return list(eng._kpools) + list(eng._vpools)

        self._mem_unregister = tracing.register_memory(
            "kv_pools", _kv_arrays, owner=self)
        tracing.install_signal_dump()

        # telemetry handles cached once (no-ops when disabled)
        self._m_requests = telemetry.counter("serving_requests_total")
        self._m_tokens = telemetry.counter("serving_tokens_total")
        self._m_prefill = telemetry.counter(
            "serving_prefill_tokens_total")
        self._m_hits = telemetry.counter(
            "serving_prefix_cache_hits_total")
        self._m_misses = telemetry.counter(
            "serving_prefix_cache_misses_total")
        self._m_preempt = telemetry.counter("serving_preemptions_total")
        self._m_evict = telemetry.counter("serving_evictions_total")
        self._m_occ = telemetry.gauge("serving_batch_occupancy")
        self._m_util = telemetry.gauge("serving_block_pool_utilization")
        self._h_wait = telemetry.histogram("serving_queue_wait_seconds")
        self._h_ttft = telemetry.histogram("serving_ttft_seconds")
        self._h_tok = telemetry.histogram(
            "serving_token_latency_seconds")
        self._m_rejected = telemetry.counter("serving_rejected_total")
        self._m_expired = telemetry.counter("serving_expired_total")
        self._m_cancelled = telemetry.counter("serving_cancelled_total")
        self._m_drains = telemetry.counter("serving_drains_total")
        self._m_qdepth = telemetry.gauge("serving_queue_depth")
        self._m_qtokens = telemetry.gauge("serving_queued_prompt_tokens")
        # perf observatory: MFU from the analytic decode-FLOPs ledger;
        # token counts and context lengths are host values, so this
        # adds no sync
        self._m_mfu = telemetry.gauge("serving_mfu")
        self._m_ftok = telemetry.gauge("serving_flops_per_token")
        self._perf_interval = max(1, int(get_env("MXTPU_PERF_INTERVAL")))
        self._perf_flops = 0.0
        self._perf_tokens = 0
        self._perf_iters = 0
        self._perf_t0 = None
        self._perf_caps = None

    # ---------------------------------------------------------- setup
    def _auto_num_blocks(self, kvh, dh):
        """Size the KV pool from planner headroom: usable device
        capacity (``MXTPU_HBM_BYTES`` override honored,
        ``MXTPU_MEM_GATE_MARGIN`` reserved) minus the settled weights
        and a per-step decode workspace (hidden states and logits),
        divided by the bytes of one block — capped at a full context
        row for every slot plus the scratch block, so a small model
        never hoards the card.  Raises a typed ``MemoryPlanError`` when
        the model alone leaves no room for one block per slot.

        The workspace is the JAX package's estimate (fp32 logits and
        residual stream per slot), kept for parity; on the card the
        captured graph's private pool and the prefill buckets' eager
        temporaries are what it stands for."""
        from ..perf import memory_planner as mp
        from ..perf.device_db import headroom, hbm_capacity
        wts_bytes = mp.tree_bytes(self._wts)
        d = self.model._d
        vocab = self.model.head.weight.shape[0]
        workspace = 4.0 * self.max_batch * (vocab + 8 * d)
        per_block = 2.0 * self.model.n_layers * self.block_size \
            * kvh * dh * 4
        avail = headroom(wts_bytes + workspace, device=self.device)
        floor = self.max_batch + 1   # one block per slot + scratch
        if avail < per_block * floor:
            plan = mp.MemoryPlan(
                params=wts_bytes, activations=workspace,
                kv_pool=per_block * floor,
                meta={"site": "serving_engine", "num_blocks": floor,
                      "quantized": self.quantized})
            raise resilience.MemoryPlanError(
                "serving_engine", plan,
                capacity=hbm_capacity(self.device))
        n = int(avail // per_block)
        cap = self.max_batch * self.max_blocks + 1
        n = min(n, cap)
        plan = mp.MemoryPlan(
            params=wts_bytes, activations=workspace,
            kv_pool=per_block * n,
            meta={"site": "serving_engine", "num_blocks": n,
                  "quantized": self.quantized})
        mp._publish_plan(plan)
        self.memory_plan = plan
        import logging
        logging.getLogger("mxtpu.memory").info(
            "serving KV pool auto-sized: %d blocks (%s)", n,
            plan.describe())
        return n

    def _counted(self, name, fn, signature):
        """Count one build of ``name``; its first call (the build's cost
        on the card: allocator growth, kernel selection) goes into the
        compile ledger with its wall time."""
        self.trace_counts[name] = self.trace_counts.get(name, 0) + 1
        first = [True]

        def called(*args):
            if not first[0]:
                return fn(*args)
            first[0] = False
            t0 = time.monotonic()
            out = fn(*args)
            self._ledger.record(signature, time.monotonic() - t0)
            return out

        return called

    def _decode_signature(self):
        return {"builder": "decode",
                "static_arg": (self.max_batch, self.max_blocks,
                               self.block_size)}

    def _get_step_fn(self):
        if self._step_fn is None:
            fn = self.model._build_paged_step(
                self.max_batch, self.max_blocks, self.block_size)
            if self.device.type != "cuda":
                # the eager step's one build (on the card, captures count)
                fn = self._counted("decode", fn, self._decode_signature())
            self._step_fn = fn
        return self._step_fn

    def _get_prefill_fn(self, suffix_len):
        # pow2 buckets, floored at one block: a prefix-cache hit can
        # shrink the suffix to a couple of tokens
        bucket = min(max(_next_pow2(suffix_len),
                         _next_pow2(self.block_size)),
                     _next_pow2(self.model._max_len))
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._prefill_fns[bucket] = self._counted(
                f"prefill_{bucket}", self.model._build_paged_prefill(
                    bucket, self.max_blocks, self.block_size),
                {"builder": "prefill", "shape": (bucket,),
                 "static_arg": (self.max_blocks, self.block_size)})
        return bucket, fn

    def _capture(self):
        """Capture the decode step as one CUDA graph over the static
        input buffers and the pools.  The warm-up steps run on a side
        stream with every slot inactive (the buffers are zero), so
        their writes land in the scratch block only."""
        t0 = time.monotonic()
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
        self._ledger.record(self._decode_signature(),
                            time.monotonic() - t0)

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
        """Shed one submission: exactly one terminal trace event (with
        the queue it would have waited behind), counters, then the typed
        raise."""
        depth = len(self._sched.waiting)
        qtok = self._sched.queued_tokens
        self._m_rejected.inc()
        self._terminal_counts["rejected"] = \
            self._terminal_counts.get("rejected", 0) + 1
        tracing.trace_event(
            "serve_reject", engine=self.engine_id,
            prompt_tokens=n_tokens, reason=reason,
            queue_depth=depth, queued_tokens=qtok)
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
        control sheds it (bounded queue, token budget, draining, or an
        injected ``serve:queue`` fault)."""
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
            try:
                # injectable shedding: serve:queue:N:error rejects the
                # Nth submission
                resilience.inject("serve", "queue")
            except resilience.TransientError:
                self._reject(len(toks), "injected")
            req = Request(self._next_id, toks, max_new, eos_id=eos_id)
            self._next_id += 1
            now = time.monotonic()
            try:
                # injectable SLO breach: serve:deadline:N:error expires
                # the Nth submission at the next iteration
                resilience.inject("serve", "deadline")
            except resilience.TransientError:
                req.deadline_ts = now - 1.0
            else:
                if ttft_deadline and ttft_deadline > 0:
                    req.ttft_deadline_ts = now + float(ttft_deadline)
                if deadline and deadline > 0:
                    req.deadline_ts = now + float(deadline)
            if req.ttft_deadline_ts is not None \
                    or req.deadline_ts is not None:
                self._deadlines_armed += 1
                self._deadline_next = min(self._deadline_next,
                                          self._next_deadline(req))
            # lifecycle and async events fire BEFORE the scheduler can
            # see the request: serve_admit must never carry a lower seq
            # than serve_enqueue
            tracing.trace_event("serve_enqueue", rid=req.id,
                                engine=self.engine_id,
                                prompt_tokens=len(toks),
                                max_new_tokens=max_new)
            self._prof_async("b", "request", req)
            self._prof_async("b", "queue_wait", req)
            self._live[req.id] = req
            self._sched.add(req)
            self._m_qdepth.set(len(self._sched.waiting))
            self._m_qtokens.set(self._sched.queued_tokens)
        self._m_requests.inc()
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
        self._m_occ.set(self._sched.n_running() / self.max_batch)
        self._m_util.set(self.pool.utilization())
        self._m_qdepth.set(len(self._sched.waiting))
        self._m_qtokens.set(self._sched.queued_tokens)
        self._perf_iters += 1
        if self._perf_iters >= self._perf_interval:
            self._publish_perf()
        return events

    # ------------------------------------------------ perf observatory
    def _serve_dtype(self):
        """Weight-stream dtype for roofline math: int8 when the weights
        are quantized, else the model's own weight dtype."""
        if self.quantized:
            return "int8"
        return _DTYPE_NAMES.get(self._wts["head"].dtype, "float32")

    def _caps(self):
        if self._perf_caps is None:
            from ..perf import caps_for
            self._perf_caps = caps_for(self.device)
        return self._perf_caps

    def _publish_perf(self):
        """Publish ``serving_mfu`` / ``serving_flops_per_token`` from
        the decode-FLOPs ledger accumulated over the last
        ``MXTPU_PERF_INTERVAL`` iterations.  Wall clock only."""
        now = time.monotonic()
        if self._perf_t0 is not None and self._perf_tokens:
            dt = now - self._perf_t0
            if dt > 0:
                peak = self._caps().peak(self._serve_dtype())
                if peak:
                    self._m_mfu.set(self._perf_flops / dt / peak)
                self._m_ftok.set(self._perf_flops / self._perf_tokens)
        self._perf_t0 = now
        self._perf_flops = 0.0
        self._perf_tokens = 0
        self._perf_iters = 0

    def perf_report(self, context_len=None, batch=None):
        """Analytic per-family cost and roofline of one batched decode
        step.

        Defaults reflect the live batch: ``context_len`` is the mean
        running KV length (half the model's context when idle) and
        ``batch`` is the running-slot count (``max_batch`` when idle).
        Host arithmetic only, safe to call while serving."""
        from ..perf import roofline, transformer_decode_cost
        m = self.model
        running = [r for r in self._sched.slots if r is not None]
        if context_len is None:
            context_len = (
                int(sum(r.n_past for r in running) / len(running))
                if running else max(1, m._max_len // 2))
        if batch is None:
            batch = len(running) or self.max_batch
        dtype = self._serve_dtype()
        dtype_size = {"int8": 1, "bfloat16": 2, "float16": 2}.get(dtype, 4)
        rep = transformer_decode_cost(
            d_model=m._d, n_layers=m.n_layers,
            vocab=m.head.weight.shape[0], context_len=context_len,
            n_heads=m.n_heads, n_kv_heads=m.n_kv_heads,
            mlp_ratio=m._mlp_ratio, attn_window=m.attn_window,
            moe_experts=m.moe_experts, batch=batch,
            dtype_size=dtype_size)
        caps = self._caps()
        return {
            "context_len": int(context_len),
            "batch": int(batch),
            "dtype": dtype,
            "device": caps.kind,
            "flops_per_token": float(
                m.decode_flops_per_token(context_len)),
            "per_family": rep.table(caps, dtype),
            "total": rep.summary(),
            "roofline": roofline(rep.flops, rep.bytes, caps, dtype),
        }

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
        self._latch_drain()
        if run:
            while self._sched.any_running():
                self.step()
        done, self._completed = self._completed, []
        return {req.id: req.tokens for req in done}

    def _latch_drain(self):
        """Latch admission off (idempotent): the counter and the one
        ``serve_drain`` event fire on the first latch, however it
        happens — ``drain()`` or the SIGTERM handler.  Touches no
        ``_completed`` state, so it is safe from a signal handler
        interrupting ``run()``."""
        if self._draining:
            return
        self._draining = True
        self._m_drains.inc()
        tracing.trace_event(
            "serve_drain", engine=self.engine_id,
            running=self._sched.n_running(),
            queue_depth=len(self._sched.waiting))

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
        other's file.  Reads host state only, never the pools, so a
        SIGTERM handler may call it wherever it interrupts ``step()``; a
        request caught mid-transit between queue and slot
        (``_in_transit``) is captured too."""
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
        tracing.trace_event("serve_snapshot", engine=self.engine_id,
                            requests=len(reqs),
                            path=str(path) if path else None)
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
        tracing.trace_event("serve_restore", engine=eng.engine_id,
                            requests=len(snapshot["requests"]))
        return eng

    def resubmit(self, entry, redispatch=False):
        """Re-admit ONE request in :meth:`_snapshot_request` entry form:
        the re-admission path under :meth:`restore` (crash resume) and
        the fleet router's failover re-dispatch (``serving/router.py``
        ships exactly this schema to a surviving replica).  Continues by
        greedy recompute: re-admission prefills ``prompt + generated``.

        Bypasses admission control: the request was already admitted
        once (here or fleet-wide at the router).  Deadlines in the entry
        are REMAINING seconds, re-armed against this process's monotonic
        clock; a request whose first token already shipped
        (``ttft_done``) does not re-arm its TTFT and never re-emits
        ``serve_first_token``.  Returns the :class:`Request`."""
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
            # one first token per request, ever: a request whose first
            # token shipped does not re-arm its TTFT
            if entry.get("ttft_done"):
                req.first_token_ts = now
                req.last_token_ts = now
            elif rem is not None:
                req.ttft_deadline_ts = now + float(rem)
            tracing.trace_event(
                "serve_enqueue", rid=req.id, engine=self.engine_id,
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens,
                restored=True, redispatch=bool(redispatch),
                generated_tokens=len(req.generated))
            self._prof_async("b", "request", req)
            self._prof_async("b", "queue_wait", req)
            self._live[req.id] = req
            self._m_requests.inc()
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
            self._retire(req)   # exactly one terminal per request
        return req

    def take_completed(self):
        """Pop and return the terminal :class:`Request` objects collected
        since the last ``run()``/``drain()``/``take_completed()``,
        without latching drain (the fleet replica's serve loop consumes
        terminals this way while it stays open for dispatches)."""
        with self._submit_lock:
            done, self._completed = self._completed, []
        return done

    def install_sigterm(self, snapshot_path, drain=True):
        """Wire SIGTERM to snapshot-then-drain: the handler writes an
        atomic :meth:`snapshot` of every in-flight request to
        ``snapshot_path``, then latches drain so the loop finishes the
        running batch and ``run()``/``stream()`` return (the process
        exits normally — the signal is consumed).  With ``drain=False``
        the previous SIGTERM disposition runs right after the snapshot
        (the default disposition kills the process: the crash-resume
        flavor; a fresh process :meth:`restore`\\ s the snapshot).

        Main-thread only (``signal.signal``'s rule); returns False when
        it cannot install.  Chains whatever PYTHON handler was there
        (``tracing.install_signal_dump``'s post-mortem, another engine's
        snapshot hook) on every path; with ``drain=True`` only the
        default-disposition re-raise is suppressed.  Falls back to the
        previous disposition entirely once the engine is garbage
        collected (the handler holds a weakref: it must never consume
        SIGTERM for an engine that no longer exists).  The handler reads
        host state only: it may interrupt ``step()`` anywhere, even
        between the input fill and the graph replay."""
        import signal as _signal
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = _signal.getsignal(_signal.SIGTERM)
        eng_ref = weakref.ref(self)

        def handler(num, frame):
            eng = eng_ref()
            if eng is not None:
                try:
                    eng.snapshot(snapshot_path)
                except Exception:   # a torn dump must not mask the
                    pass            # signal's actual handling
                try:
                    eng._latch_drain()  # drains_total counts SIGTERM
                except Exception:       # the latch must hold even if
                    eng._draining = True    # telemetry raises
                if drain:
                    # consume the signal for THIS engine's graceful
                    # exit, but run any chained Python handler first;
                    # only the default-disposition re-raise is
                    # suppressed (it would kill the process drain means
                    # to let exit)
                    if callable(prev):
                        prev(num, frame)
                    return
            # engine gone (or drain=False): the previous disposition
            # runs — a dead weakref consuming every SIGTERM would make
            # the process unkillable short of SIGKILL
            if callable(prev):
                prev(num, frame)
            elif prev == _signal.SIG_IGN:
                return
            else:
                _signal.signal(num, _signal.SIG_DFL)
                _signal.raise_signal(num)

        try:
            _signal.signal(_signal.SIGTERM, handler)
        except (ValueError, OSError):
            return False
        return True

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
                resilience.inject("serve", "request")
            except resilience.TransientError as exc:
                self._fail(req, exc)
                continue
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
            wait = req.admit_ts - req.enqueue_ts
            req.queue_wait_s += wait
            self._h_wait.observe(wait)
            self._m_hits.inc(n_cached)
            self._m_misses.inc(len(toks) - n_cached)
            self.prefix_hit_tokens += n_cached
            req.block_ids = matched + fresh
            self._sched.place(req, slot)
            self._in_transit = None
            tracing.trace_event(
                "serve_admit", rid=req.id, engine=self.engine_id,
                slot=slot, blocks=len(req.block_ids),
                cached_tokens=n_cached, queue_wait_s=round(wait, 6),
                preemptions=req.preemptions)
            self._prof_async("e", "queue_wait", req)
            self._prof_async("b", "prefill", req)

            suffix = toks[n_cached:]
            bucket, fn = self._get_prefill_fn(len(suffix))
            suf = np.zeros(bucket, np.int64)
            suf[:len(suffix)] = suffix
            row = np.zeros(self.max_blocks, np.int64)
            row[:len(req.block_ids)] = req.block_ids
            t_pre = time.monotonic()
            with telemetry.span("serve_prefill"), torch.no_grad():
                nxt, logits = fn(
                    self._wts, self._kpools, self._vpools,
                    torch.as_tensor(row, device=self.device), n_cached,
                    torch.as_tensor(suf, device=self.device),
                    len(suffix))
                tok = int(nxt)  # sync-ok: first-token read seeds the decode loop
            dt_pre = time.monotonic() - t_pre
            req.prefill_s += dt_pre
            tracing.trace_event(
                "serve_prefill", rid=req.id, engine=self.engine_id,
                slot=slot, suffix_tokens=len(suffix), bucket=bucket,
                seconds=round(dt_pre, 6))
            self._prof_async("e", "prefill", req)
            self._prof_async("b", "decode", req)
            self._m_prefill.inc(len(suffix))
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
        freed = len(req.block_ids)
        self._in_transit = req      # out of the slot, not yet queued
        self._sched.clear(req)
        if req.block_ids:
            self.pool.free(req.block_ids)
        req.block_ids = []
        req.n_past = 0
        req.state = QUEUED
        req.preemptions += 1
        self._m_preempt.inc()
        # a preempted runner is queued again: its queue-wait clock
        # restarts here
        req.enqueue_ts = time.monotonic()
        tracing.trace_event(
            "serve_preempt", rid=req.id, engine=self.engine_id,
            generated_tokens=len(req.generated), freed_blocks=freed,
            preemptions=req.preemptions)
        self._prof_async("e", "decode", req)
        self._sched.push_front(req)
        self._in_transit = None
        tracing.trace_event("serve_requeue", rid=req.id,
                            engine=self.engine_id,
                            queue_depth=len(self._sched.waiting))
        self._prof_async("b", "queue_wait", req)

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
        """One batched decode step and the per-iteration token read.

        Watchdog: with ``step_timeout`` > 0, an iteration whose decode
        (injection included — ``serve:step:N:hang`` is the test vector)
        runs past the budget logs loudly, records
        ``serve_step_overrun`` and dumps the flight recorder
        (``MXTPU_TRACE_DUMP``).  Detection, not interruption.  The
        injection runs before the host inputs are filled, so an injected
        error leaves no half-filled buffer; the clock and the
        ``serve_decode`` span cover the replay AND the token read, the
        loop's one device-to-host sync, so a wedged device cannot pass
        unseen behind an asynchronous launch."""
        t_step = time.monotonic()
        resilience.inject("serve", "step")
        slots = self._sched.slots
        self._fill_decode_inputs()
        with telemetry.span("serve_decode"):
            nxt, logits = self._run_step()
            toks = nxt.tolist()  # sync-ok: the per-iteration token read
        dt_step = time.monotonic() - t_step
        if self.step_timeout > 0 and dt_step > self.step_timeout:
            tracing.trace_event(
                "serve_step_overrun", engine=self.engine_id,
                seconds=round(dt_step, 6), budget=self.step_timeout,
                running=self._sched.n_running())
            get_logger().warning(
                "serving: decode step took %.3fs against the %.3fs "
                "budget (MXTPU_SERVE_STEP_TIMEOUT); flight-recorder "
                "post-mortem follows when MXTPU_TRACE_DUMP is set",
                dt_step, self.step_timeout)
            tracing.dump_on_fault("serve_step_overrun")
        for i, req in enumerate(list(slots)):
            if req is None:
                continue
            # perf ledger: analytic FLOPs for this token at its context
            # length (host arithmetic, no device read)
            self._perf_flops += self.model.decode_flops_per_token(
                req.n_past)
            self._perf_tokens += 1
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
            self._h_ttft.observe(now - req.submit_ts)
            # serving-side anomaly watch: TTFT drift (host floats)
            telemetry.anomaly_watch("serving").observe(
                {"ttft": now - req.submit_ts})
            tracing.trace_event(
                "serve_first_token", rid=req.id, engine=self.engine_id,
                ttft_s=round(now - req.submit_ts, 6),
                queue_wait_s=round(req.queue_wait_s, 6),
                prefill_s=round(req.prefill_s, 6))
        else:
            self._h_tok.observe(now - req.last_token_ts)
            telemetry.anomaly_watch("serving").observe(
                {"token_latency": now - req.last_token_ts})
        req.last_token_ts = now
        req.generated.append(tok)
        self._m_tokens.inc()
        events.append((req, tok))
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._retire(req)

    # ----------------------------------------------- terminal paths
    def _close_wait(self, req, now):
        """Close the open queue-wait segment of a QUEUED request (every
        terminal path records its wait).  Returns the request's open
        async phase: ``queue_wait`` when queued, ``decode`` when
        running."""
        if req.state == QUEUED:
            wait = now - req.enqueue_ts
            req.queue_wait_s += wait
            self._h_wait.observe(wait)
            return "queue_wait"
        return "decode"

    def _release(self, req, now):
        """Shared terminal release: the slot cleared and every pool
        block freed in the SAME iteration the terminal was decided."""
        open_phase = self._close_wait(req, now)
        self._sched.clear(req)
        if req.block_ids:
            self.pool.free(req.block_ids)
        req.block_ids = []
        req.finish_ts = now
        return open_phase

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
        now = time.monotonic()
        self._release(req, now)
        req.state = FINISHED
        tracing.trace_event(
            "serve_retire", rid=req.id, engine=self.engine_id,
            tokens_generated=len(req.generated),
            preemptions=req.preemptions,
            queue_wait_s=round(req.queue_wait_s, 6),
            prefill_s=round(req.prefill_s, 6))
        self._terminal_async(req, "decode")
        self._finalize(req)

    def _fail(self, req, exc):
        """Evict a poisoned or unservable request without touching
        batchmates: the queue wait is recorded, a terminal
        ``serve_evict`` event closes the lifecycle, and the flight
        recorder dumps (``MXTPU_TRACE_DUMP``)."""
        get_logger().warning(
            "serving: evicting request %s after injected/terminal "
            "fault: %s", req.id, exc)
        now = time.monotonic()
        open_phase = self._release(req, now)
        req.state = FAILED
        req.error = exc
        self._m_evict.inc()
        tracing.trace_event(
            "serve_evict", rid=req.id, engine=self.engine_id,
            error=str(exc), tokens_generated=len(req.generated),
            queue_wait_s=round(req.queue_wait_s, 6),
            preemptions=req.preemptions)
        self._terminal_async(req, open_phase)
        self._finalize(req)
        tracing.dump_on_fault("serving_eviction")

    def _expire(self, req, why, now):
        """Terminal ``expired``: the request's TTFT or total deadline
        passed.  Partial output is retained on the handle; ``req.error``
        carries a typed DeadlineExceededError."""
        open_phase = self._release(req, now)
        req.state = EXPIRED
        req.error = resilience.DeadlineExceededError(
            f"serving request {req.id} missed its {why} deadline "
            f"after {len(req.generated)} generated token(s)")
        self._m_expired.inc()
        tracing.trace_event(
            "serve_expire", rid=req.id, engine=self.engine_id,
            why=why, tokens_generated=len(req.generated),
            queue_wait_s=round(req.queue_wait_s, 6),
            preemptions=req.preemptions)
        self._terminal_async(req, open_phase)
        self._finalize(req)

    def _cancel_now(self, req, now):
        """Terminal ``cancelled``: partial output retained, blocks
        freed this iteration."""
        open_phase = self._release(req, now)
        req.state = CANCELLED
        self._m_cancelled.inc()
        tracing.trace_event(
            "serve_cancel", rid=req.id, engine=self.engine_id,
            tokens_generated=len(req.generated),
            queue_wait_s=round(req.queue_wait_s, 6),
            preemptions=req.preemptions)
        self._terminal_async(req, open_phase)
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
        for req in tracing.safe_list(self._sched.waiting):
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
    def _prof_async(self, ph, name, req):
        """Emit one chrome-tracing async (b/e) event for a request phase
        while the profiler runs; each request id is an async track on a
        named serving lane.  The lane is a function of the PHASE:
        ``request``/``queue_wait`` on the queue lane, compute phases on
        the slot of the request's FIRST admission (``last_slot``), so a
        re-admission into another slot never splits the track."""
        from .. import profiler
        prof = profiler._profiler
        if not prof.running:
            return
        if name in ("request", "queue_wait") or req.last_slot is None:
            lane = profiler.SERVE_QUEUE_LANE
        else:
            lane = profiler.SERVE_SLOT_LANE0 + req.last_slot
        prof.add_async_event(name, f"req{self.engine_id}.{req.id}", ph,
                             category="serving", lane=lane)

    def _terminal_async(self, req, open_phase):
        """Close a request's open async phases at its terminal
        transition (``open_phase`` from :meth:`_close_wait`)."""
        self._prof_async("e", open_phase, req)
        self._prof_async("e", "request", req)

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
        pool state.  Host bookkeeping only, no device access; safe from
        a monitoring thread while the engine runs."""
        live = [self._request_summary(r)
                for r in tracing.safe_list(self._sched.waiting)
                + self._sched.running()]
        return {
            "requests": tracing.safe_list(self._req_summaries),
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
