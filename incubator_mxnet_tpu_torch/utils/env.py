"""Runtime environment-flag registry (twin of
``incubator_mxnet_tpu/utils/env.py``: the same flags, defaults and
parsing, so ``list_env()`` is the same in both packages).

The reference reads ~29 documented env vars ad hoc via ``dmlc::GetEnv``
(ref: docs/faq/env_var.md).  Here flags are declared once in a central
registry so ``list_env()`` is always complete and typos fail loudly.

Flags use the ``MXTPU_`` prefix; the reference's ``MXNET_`` prefix is
accepted as a fallback for familiarity.
"""
import os

_REGISTRY = {}


class EnvFlag:
    """A declared environment flag with type, default and docstring."""

    __slots__ = ("name", "type", "default", "help")

    def __init__(self, name, type_, default, help_=""):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_

    def get(self):
        raw = os.environ.get(self.name)
        if raw is None and self.name.startswith("MXTPU_"):
            raw = os.environ.get("MXNET_" + self.name[len("MXTPU_"):])
        if raw is None:
            return self.default
        if self.type is bool:
            return raw not in ("0", "false", "False", "")
        try:
            return self.type(raw)
        except ValueError:
            return self.default


def register_env(name, type_, default, help_=""):
    flag = EnvFlag(name, type_, default, help_)
    _REGISTRY[name] = flag
    return flag


def get_env(name):
    """Read a registered env flag (raises KeyError on unregistered names)."""
    return _REGISTRY[name].get()


def list_env():
    """All registered flags, for docs/diagnose output."""
    return dict(_REGISTRY)


# Core runtime flags (analogs of the reference's engine/exec/kvstore vars).
register_env("MXTPU_ENGINE_TYPE", str, "async",
             "'async' (default, XLA async dispatch) or 'naive' "
             "(block after every op; analog of MXNET_ENGINE_TYPE=NaiveEngine)")
register_env("MXTPU_EXEC_BULK_EXEC_TRAIN", bool, True,
             "fuse forward+backward into one compiled executable")
register_env("MXTPU_DEFAULT_DTYPE", str, "float32",
             "default dtype for new arrays")
register_env("MXTPU_ENABLE_X64", bool, False, "enable float64/int64 support")
register_env("MXTPU_PROFILER_AUTOSTART", bool, False,
             "start the profiler at import time")
register_env("MXTPU_PROFILER_DIR", str, "profile_output",
             "directory for profiler trace dumps")
register_env("MXTPU_KVSTORE_BIGARRAY_BOUND", int, 1000000,
             "size threshold for chunked kvstore reductions")
register_env("MXTPU_CPU_WORKER_NTHREADS", int, 4,
             "host worker threads for data pipeline")
register_env("MXTPU_SEED", int, 0, "global RNG seed at import")

# Graph optimization (graph/; docs/graph_passes.md).
register_env("MXTPU_GRAPH_OPT", int, 1,
             "graph-optimization level for Executor.bind and CachedOp "
             "symbol tracing: 0 disables the pass pipeline, 1 "
             "(default) runs the safe structural passes (identity/"
             "transpose-pair elimination, constant folding, CSE, "
             "dead-node pruning), 2 adds elementwise-chain "
             "pre-fusion")
register_env("MXTPU_CACHEDOP_CAPACITY", int, 64,
             "max compiled signatures a hybridized block's CachedOp "
             "retains (LRU eviction); <=0 disables the bound")

# Serving tier (serving/; docs/serving.md).
register_env("MXTPU_SERVE_BLOCK_SIZE", int, 16,
             "tokens per paged-KV block in the serving engine; "
             "smaller = less tail waste per sequence, larger = "
             "fewer gather indices per step")
register_env("MXTPU_SERVE_NUM_BLOCKS", int, 512,
             "KV block-pool size per layer (block 0 is the reserved "
             "scratch block); bounds total serving HBM at "
             "n_layers * 2 * num_blocks * block_size * kv_heads * "
             "head_dim floats")
register_env("MXTPU_SERVE_MAX_BATCH", int, 8,
             "concurrent decode slots in the continuous-batching "
             "scheduler (the compiled step's batch dimension)")
register_env("MXTPU_SERVE_PREFIX_CACHE", bool, True,
             "share prompt-prefix KV blocks across requests by "
             "token-hash (copy-free; refcounted); 0 disables")
register_env("MXTPU_SERVE_QUANT", str, "off",
             "serving weight quantization: 'off' (fp32) or 'int8' "
             "(per-output-channel symmetric, fp32 scales, "
             "dequantized inside the compiled step)")

# Serving SLO / survival layer (docs/serving.md "SLOs, shedding,
# and drain").  All deadline arithmetic is monotonic-clock
# (lint-enforced); 0 disables each knob.
register_env("MXTPU_SERVE_TTFT_DEADLINE", float, 0.0,
             "default per-request time-to-first-token deadline (s) "
             "for ServingEngine.submit; a request still waiting for "
             "its first token past this expires (terminal state "
             "'expired', blocks freed same iteration); 0 disables")
register_env("MXTPU_SERVE_DEADLINE", float, 0.0,
             "default per-request total deadline (s): submit -> "
             "last token; an in-flight request past it expires with "
             "its partial output retained; 0 disables")
register_env("MXTPU_SERVE_QUEUE_LIMIT", int, 0,
             "bounded serving wait queue: submit() raises "
             "ServeRejectedError once this many requests are "
             "queued, shedding load at the door instead of letting "
             "queue wait grow without bound; 0 = unbounded")
register_env("MXTPU_SERVE_QUEUE_TOKENS", int, 0,
             "queued prompt-token budget: submit() rejects when the "
             "waiting queue's summed token length would exceed "
             "this (bounds requeue/recompute debt, not just "
             "request count); 0 = unbounded")
register_env("MXTPU_SERVE_STEP_TIMEOUT", float, 0.0,
             "decode-step watchdog budget (s): an engine iteration "
             "whose decode step runs longer logs loudly, records a "
             "serve_step_overrun trace event and dumps the flight "
             "recorder (MXTPU_TRACE_DUMP) — detection, not "
             "interruption: a wedged device call is the heartbeat "
             "monitor's job; 0 disables")

# Serving fleet (serving/rpc.py, router.py, replica.py,
# tools/launch.py --serve-fleet; docs/serving.md "Fleet").
register_env("MXTPU_RPC_TIMEOUT", float, 30.0,
             "default per-call deadline (s) for every fleet RPC "
             "socket wait (connect, frame send, frame recv); rpc.py "
             "refuses unbounded waits, so 0 is coerced to this "
             "default rather than disabling the bound")
register_env("MXTPU_ROUTER_PORT", int, 0,
             "port ServingRouter.listen() binds its client-facing "
             "RPC front door to; 0 = ephemeral (the bound port is "
             "reported by listen())")
register_env("MXTPU_FLEET_REPLICAS", int, 0,
             "replica count exported by tools/launch.py "
             "--serve-fleet to every fleet process; 0 = not "
             "launcher-managed")
register_env("MXTPU_BREAKER_THRESHOLD", int, 3,
             "consecutive per-replica dispatch failures that trip "
             "the router's circuit breaker from closed to open")
register_env("MXTPU_BREAKER_COOLDOWN", float, 5.0,
             "seconds an open breaker waits before half-open admits "
             "exactly one probe request (monotonic clock)")
register_env("MXTPU_FLEET_ROLE", str, "",
             "role exported by tools/launch.py --serve-fleet to "
             "each fleet process: 'router' or 'replica' (empty = "
             "not fleet-launched)")
register_env("MXTPU_REPLICA_ADDRS", str, "",
             "comma-separated host:port list of replica RPC servers "
             "exported by tools/launch.py --serve-fleet to the "
             "router process")
register_env("MXTPU_REPLICA_PORT", int, 0,
             "port a replica worker binds its RPC server to "
             "(exported per replica by tools/launch.py "
             "--serve-fleet); 0 = ephemeral")

# Resilience layer (resilience.py; docs/resilience.md).
register_env("MXTPU_COLLECTIVE_TIMEOUT", float, 600.0,
             "wall-clock deadline (s) for dist collectives; a hung "
             "allreduce/broadcast/barrier raises a diagnostic "
             "DeadlineExceededError instead of blocking forever; "
             "0 disables")
register_env("MXTPU_RETRY_MAX", int, 4,
             "max retries for transient dist failures "
             "(coordinator join, kvstore push/pull)")
register_env("MXTPU_RETRY_BASE_DELAY_S", float, 0.1,
             "first backoff delay (s); doubles per retry")
register_env("MXTPU_RETRY_MAX_DELAY_S", float, 5.0,
             "backoff delay cap (s)")
register_env("MXTPU_RETRY_JITTER", float, 0.25,
             "fraction of each backoff delay added as random jitter")
register_env("MXTPU_FAULT_SPEC", str, "",
             "deterministic fault injection: comma-separated "
             "scope:op:nth:kind entries, e.g. "
             "'collective:allreduce:2:hang,checkpoint:save:1:truncate'")
register_env("MXTPU_FAULT_HANG_S", float, 3600.0,
             "how long an injected 'hang' fault sleeps")
register_env("MXTPU_HEARTBEAT_FILE", str, "",
             "path the worker's heartbeat thread refreshes (set per "
             "worker by tools/launch.py; empty disables heartbeats)")
register_env("MXTPU_HEARTBEAT_INTERVAL", float, 2.0,
             "seconds between per-worker heartbeat file refreshes")
register_env("MXTPU_HEARTBEAT_TIMEOUT", float, 60.0,
             "launcher kills a worker whose heartbeat is staler than "
             "this (s); 0 disables hung-worker detection")
register_env("MXTPU_CKPT_FALLBACK", bool, True,
             "on corrupt/truncated checkpoint load, fall back to the "
             "newest earlier checkpoint that validates")

# Elastic multi-chip training (parallel/checkpoint.py, dist.py,
# tools/launch.py --elastic; docs/elastic.md).
register_env("MXTPU_CKPT_KEEP", int, 3,
             "sharded-checkpoint generations retained per directory "
             "(parallel.checkpoint.save_sharded prunes older "
             "fully-committed generations past this); <=0 keeps all")
register_env("MXTPU_ELASTIC", bool, False,
             "exported by tools/launch.py --elastic: workers treat "
             "an uncaught CollectiveAbortedError / collective "
             "DeadlineExceededError as a coordinated elastic abort "
             "and exit with the distinct elastic code (14) so the "
             "launcher restarts on the surviving world instead of "
             "counting a crash")
register_env("MXTPU_WORLD_GENERATION", int, 0,
             "monotonically increasing world generation exported by "
             "tools/launch.py to every (re)launched worker, so logs "
             "and telemetry attribute which world a metric came "
             "from; 0 = not launcher-managed")

# Training-step sentinel (resilience.NumericGuard, optimizer,
# gluon/trainer, module fit loops; docs/numeric_stability.md).
register_env("MXTPU_NONFINITE_POLICY", str, "off",
             "non-finite gradient/loss policy for guarded training "
             "steps: off (default) | warn | skip (drop the update, "
             "keep weights/optimizer/LR state untouched) | raise "
             "(BadStepError on the first bad step)")
register_env("MXTPU_GUARD_INTERVAL", int, 1,
             "guarded steps between device->host reads of the fused "
             "finiteness scalar; the sentinel's entire sync cost is "
             "one scalar read per interval")
register_env("MXTPU_MAX_BAD_STEPS", int, 10,
             "consecutive bad steps before DivergedError (fit loops "
             "roll back to the newest valid checkpoint and re-raise "
             "for the launcher restart loop); 0 disables")
register_env("MXTPU_LOSS_SPIKE_FACTOR", float, 0.0,
             "NumericGuard.check_loss flags a finite loss larger "
             "than this factor x its running mean as a bad step; "
             "0 (default) checks only finiteness")
register_env("MXTPU_LOSS_SCALE", float, 1.0,
             "initial loss scale for optimizer.LossScaler (gluon "
             "Trainer mixed-precision loops multiply the loss by "
             "Trainer.loss_scale; step() rescales gradients back)")
register_env("MXTPU_LOSS_SCALE_DYNAMIC", bool, False,
             "grow/backoff the loss scale dynamically on "
             "overflow signals from the step sentinel")
register_env("MXTPU_LOSS_SCALE_GROWTH", float, 2.0,
             "dynamic loss-scale growth factor after "
             "MXTPU_LOSS_SCALE_WINDOW consecutive good steps")
register_env("MXTPU_LOSS_SCALE_BACKOFF", float, 0.5,
             "dynamic loss-scale backoff factor on an overflow "
             "(non-finite) step")
register_env("MXTPU_LOSS_SCALE_WINDOW", int, 2000,
             "consecutive good steps before the dynamic loss scale "
             "grows")
register_env("MXTPU_LOSS_SCALE_MAX", float, float(2 ** 24),
             "upper bound for the dynamic loss scale")

# Telemetry (telemetry.py; docs/observability.md).
register_env("MXTPU_TELEMETRY", bool, True,
             "process-wide metrics registry + step-timeline spans "
             "(docs/observability.md); 0 disables every registry "
             "write, span, and emitter thread — instrumented paths "
             "become no-ops")
register_env("MXTPU_TELEMETRY_FILE", str, "",
             "path the TelemetryEmitter appends periodic JSONL "
             "snapshots to (a Prometheus textfile is kept at "
             "<file>.prom); nonzero-rank workers write to "
             "<file>.rank<N> so a launcher-shared path never has "
             "two writers; empty disables the emitter thread")
register_env("MXTPU_TELEMETRY_INTERVAL", float, 10.0,
             "seconds between TelemetryEmitter snapshot flushes")
register_env("MXTPU_TELEMETRY_MAX_MB", float, 64.0,
             "rotate the JSONL telemetry file to <file>.1 past this "
             "size; 0 disables rotation")
register_env("MXTPU_STATUS_INTERVAL", float, 30.0,
             "seconds between tools/launch.py aggregated cluster "
             "status lines (built from per-worker heartbeat "
             "telemetry snapshots); 0 disables")

# Introspection plane (debugz.py, tools/debugz.py;
# docs/observability.md "Introspection plane").
register_env("MXTPU_DEBUGZ", bool, True,
             "embed the read-only debugz RPC endpoint in every "
             "long-running process (train ranks, serving router/"
             "replicas, remote data-service hosts); 0 disables the "
             "endpoint entirely — no socket, no thread")
register_env("MXTPU_DEBUGZ_PORT", int, 0,
             "port the per-process debugz endpoint binds; 0 = "
             "ephemeral (pair with MXTPU_DEBUGZ_PORTFILE for "
             "race-free discovery)")
register_env("MXTPU_DEBUGZ_PORTFILE", str, "",
             "path the debugz endpoint writes its bound port to "
             "(atomic temp+rename, the same handshake as the "
             "replica/data-service --port-file); exported per rank "
             "by tools/launch.py so live status polls can find the "
             "endpoint; empty skips the port file")
register_env("MXTPU_ANOMALY_WINDOW", int, 64,
             "rolling window (samples) the AnomalyWatch keeps per "
             "timeline component for its median/MAD baseline")
register_env("MXTPU_ANOMALY_THRESHOLD", float, 6.0,
             "MAD-normalized deviation score at which AnomalyWatch "
             "opens an anomaly episode (value > median + "
             "threshold * MAD)")
register_env("MXTPU_ANOMALY_MIN_STEPS", int, 16,
             "warmup samples per component before AnomalyWatch may "
             "open an episode (an empty baseline flags everything)")
register_env("MXTPU_ANOMALY_COOLDOWN", int, 8,
             "consecutive below-threshold samples that close an "
             "open anomaly episode (hysteresis: one sustained "
             "regression is one episode, not a flapping stream)")

# Flight recorder / tracing (tracing.py; docs/observability.md).
register_env("MXTPU_TRACE_BUFFER", int, 4096,
             "flight-recorder ring-buffer capacity (structured "
             "events retained for post-mortem dumps); older events "
             "are evicted and counted as dropped")
register_env("MXTPU_TRACE_DUMP", str, "",
             "path the flight recorder dumps to (atomic JSONL) on "
             "DivergedError / DataPipelineError / serving eviction "
             "faults / SIGTERM+SIGUSR1; empty (default) disables "
             "automatic fault dumps (tracing.dump(path) always "
             "works)")
register_env("MXTPU_COMPILE_BUDGET", float, 0.0,
             "retrace-storm watchdog: warn loudly when cumulative "
             "compile wall-time across all ledger sites crosses "
             "this many seconds (and again at every doubling); "
             "0 disables")

# Data-pipeline resilience (io/, gluon/data/; docs/data_pipeline.md).
register_env("MXTPU_DATA_TIMEOUT", float, 600.0,
             "wall-clock deadline (s) on input-pipeline queue waits; "
             "a stalled prefetch worker or DataLoader raises a "
             "diagnostic DataPipelineError naming the source instead "
             "of blocking next() forever; 0 disables")
register_env("MXTPU_DATA_WORKER_RESTARTS", int, 2,
             "times a DataLoader re-dispatches the index batch of a "
             "dead (segfaulted / OOM-killed) worker process before "
             "raising DataPipelineError")
register_env("MXTPU_MAX_BAD_RECORDS", int, 0,
             "bad-record budget for record-backed iterators: corrupt "
             "records are skipped and logged until this many have "
             "been seen, then the iterator raises DataPipelineError; "
             "0 (default) raises on the first bad record")
register_env("MXTPU_DL_DEAD_GRACE", float, 60.0,
             "seconds a multiprocess DataLoader waits for a dead "
             "worker's in-flight batch before declaring it lost and "
             "re-dispatching (MXTPU_DATA_WORKER_RESTARTS budget)")

# Sharded multi-process data service (data_service/;
# docs/data_service.md).
register_env("MXTPU_DATA_WORKERS", int, 2,
             "decode worker processes a DataServiceIter spawns when "
             "num_workers is not given; tools/launch.py "
             "--data-workers exports this to every rank")
register_env("MXTPU_DATA_RING_DEPTH", int, 4,
             "batches each data-service shard stages in its bounded "
             "shared-memory ring; backpressure blocks the worker — "
             "never grows memory — once the ring is full (host "
             "memory is num_workers * depth * batch_bytes)")
register_env("MXTPU_DATA_REMOTE_ADDRS", str, "",
             "comma-separated host:port list of RemoteShardServer "
             "ranks (data_service/net.py); when set (or "
             "remote_addrs= is passed) the LAST len(addrs) shards "
             "of a DataServiceIter stream over sockets instead of "
             "local shm rings — same merge order, bit-identical "
             "batches; tools/launch.py --data-hosts exports it")
register_env("MXTPU_DATA_NET_CREDITS", int, 0,
             "in-flight batch frames a remote data-service shard "
             "may send ahead of consumption (credit-based "
             "backpressure mirroring the shm ring's semaphore "
             "contract); 0 (default) uses the shard's ring depth")
register_env("MXTPU_DATA_HOST_GRACE", float, 10.0,
             "seconds a train host tolerates total silence (no "
             "batch, heartbeat, or pong frames) from a remote "
             "data-service host before declaring it dead and "
             "failing its shards over (docs/data_service.md "
             "\"Remote ranks\")")
register_env("MXTPU_DEVICE_PREFETCH_DEPTH", int, 2,
             "in-flight device batches a DevicePrefetchIter stages "
             "when its depth argument is not given (HBM use is "
             "depth * batch_bytes); deepen it when a multi-process "
             "producer outruns the depth-2 default")

# Perf observatory (docs/observability.md "Perf observatory").
register_env("MXTPU_PERF_INTERVAL", int, 10,
             "training steps between train_mfu/train_mbu/"
             "train_tokens_per_sec gauge publications when no guard "
             "cadence is supplied; publication is wall-clock-only "
             "and never adds a device->host sync")
register_env("MXTPU_PERF_GATE_BAND", float, 0.10,
             "relative noise band tools/bench_gate.py tolerates "
             "before a headline metric below best-so-far counts as "
             "a regression (0.10 = 10%)")
register_env("MXTPU_PERF_CPU_PEAK_GFLOPS", float, 100.0,
             "nominal peak GFLOP/s assumed for a CPU host in the "
             "device capability DB (perf/device_db.py) so roofline/"
             "MFU plumbing produces a verdict on CPU-only runs; "
             "reports computed against it carry nominal_peaks=true")
register_env("MXTPU_PERF_CPU_GBPS", float, 25.0,
             "nominal CPU memory bandwidth (GB/s) for the device "
             "capability DB's roofline math on CPU-only hosts")

# Memory planner + preflight OOM gate (docs/memory.md).
register_env("MXTPU_MEM_POLICY", str, "degrade",
             "memory-pressure policy for the preflight HBM gate and "
             "the runtime OOM guard: off (never plan, raw XLA "
             "RESOURCE_EXHAUSTED kills the job), warn (plan + log "
             "overflow, never act), degrade (walk the ladder: "
             "enable remat -> raise grad_accum -> typed "
             "MemoryPlanError)")
register_env("MXTPU_HBM_BYTES", float, 0.0,
             "per-device HBM capacity override in bytes for "
             "perf/device_db.py; 0 (default) uses the device "
             "generation's known capacity (CPU hosts get a nominal "
             "value tagged nominal_hbm=true); shrink it to exercise "
             "the degrade ladder deterministically")
register_env("MXTPU_MEM_GATE_MARGIN", float, 0.05,
             "fraction of device HBM the preflight gate holds back "
             "as safety margin (XLA fragmentation + unmodeled "
             "scratch): a plan overflows when predicted peak > "
             "(1 - margin) * capacity")
