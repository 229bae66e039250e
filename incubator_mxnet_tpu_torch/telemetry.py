"""Unified run telemetry: metrics registry, step-timeline spans, and
periodic snapshot emission (twin of ``incubator_mxnet_tpu/telemetry.py``;
docs/observability.md).

- :class:`MetricRegistry` — process-wide Counter / Gauge / Histogram
  (bounded reservoir) store.  Thread-safe; every accessor degrades to
  a shared no-op when ``MXTPU_TELEMETRY=0``, so disabled runs pay one
  env read and nothing else (no locks, no allocation, no writes).
- :func:`span` — a context manager timing a wall-clock section into
  the registry (``span_<name>_seconds`` histogram) AND into the
  chrome://tracing profiler stream when the profiler is running.
  Spans never touch a tensor: they cost two ``perf_counter`` reads
  and never synchronize the card.
- :class:`TelemetryEmitter` — a daemon thread flushing periodic JSONL
  snapshots (``MXTPU_TELEMETRY_FILE``, every
  ``MXTPU_TELEMETRY_INTERVAL`` seconds, rotated at
  ``MXTPU_TELEMETRY_MAX_MB``) plus an atomically-replaced
  Prometheus-style textfile (``<file>.prom``).

Per-worker snapshots additionally ride the resilience heartbeat files
(:func:`heartbeat_payload`, appended by ``resilience._beat`` as a
second line).  Metric names, help text (read from the
docs/observability.md catalog) and the snapshot and exposition
formats are the JAX package's, so the two packages' outputs compare
equal for the same sequence of calls.

Stdlib-only and import-light.  The locks here are re-created in a
forked child (``os.register_at_fork``), so a decode worker forked
while another thread held one never waits on it.
"""
import json
import os
import re
import threading
import time
from collections import deque

from .utils.env import get_env

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "TelemetryEmitter", "AnomalyWatch", "enabled",
           "get_registry", "counter", "gauge", "histogram", "span",
           "snapshot", "prometheus_text", "heartbeat_payload",
           "start_emitter", "maybe_start_emitter", "stop_emitter",
           "anomaly_watch", "anomaly_verdicts"]


def enabled():
    """Whether telemetry is armed (``MXTPU_TELEMETRY``, default on).

    The disabled fast path is this one env read: every factory below
    returns the shared no-op metric/span, so instrumented code sites
    stay branch-free."""
    return get_env("MXTPU_TELEMETRY")


# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------


class Counter:
    """Monotonically increasing count (events, retries, bad steps)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, loss scale)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = float(v)

    @property
    def value(self):
        return self._value


class Histogram:
    """Distribution with exact count/sum/min/max and a *bounded*
    reservoir of the most recent ``max_samples`` observations for
    percentiles — memory stays O(max_samples) over any run length."""

    __slots__ = ("name", "count", "sum", "min", "max", "_samples",
                 "_lock")

    def __init__(self, name, max_samples=512):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._samples = deque(maxlen=max_samples)
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self._samples.append(v)

    def percentile(self, q):
        with self._lock:
            data = sorted(self._samples)
        if not data:
            return None
        idx = min(len(data) - 1, max(0, int(q * (len(data) - 1))))
        return data[idx]

    def stats(self):
        with self._lock:
            data = sorted(self._samples)
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min, "max": self.max}
        for tag, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            out[tag] = (data[min(len(data) - 1,
                                 int(q * (len(data) - 1)))]
                        if data else None)
        return out


class _NullMetric:
    """Shared no-op stand-in for every metric type while telemetry is
    disabled — instrumented sites call inc/set/observe unconditionally
    and this absorbs them with zero state."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    @property
    def value(self):
        return 0


NULL_METRIC = _NullMetric()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class MetricRegistry:
    """Process-wide named-metric store.

    Creation is get-or-create keyed by name (one Counter object per
    name for the process lifetime — callers may cache the returned
    object); a name re-requested as a different type raises, because
    two writers disagreeing on a metric's type is always a bug."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, max_samples=512):
        return self._get(name, Histogram, max_samples=max_samples)

    def reset(self):
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self):
        """One coherent host-side snapshot: counters, gauges, and
        histogram stats, stamped with wall time and worker rank.  No
        device access of any kind happens here."""
        with self._lock:
            metrics = list(self._metrics.values())
        counters, gauges, hists = {}, {}, {}
        for m in metrics:
            if isinstance(m, Counter):
                counters[m.name] = m.value
            elif isinstance(m, Gauge):
                gauges[m.name] = m.value
            else:
                hists[m.name] = m.stats()
        try:
            rank = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)
        except ValueError:
            rank = 0
        return {"ts": time.time(), "rank": rank,
                "counters": counters, "gauges": gauges,
                "histograms": hists}

    def prometheus_text(self, prefix="mxtpu_"):
        """Prometheus exposition-format text of the current state:
        counters/gauges as-is, histograms as summary ``_count``/
        ``_sum`` plus ``_p50``/``_p99`` quantile gauges.  Every
        metric carries ``# TYPE`` and (where the docs catalog knows
        it) ``# HELP`` — the help text comes from the same
        docs/observability.md tables ci/lint.py already enforces, so
        the exposition and the catalog cannot drift apart."""
        snap = self.snapshot()
        lines = []

        def head(name, kind):
            lines.append(f"# TYPE {prefix}{name} {kind}")
            doc = _metric_help(name)
            if doc:
                lines.append(f"# HELP {prefix}{name} {doc}")

        for name, v in sorted(snap["counters"].items()):
            head(name, "counter")
            lines.append(f"{prefix}{name} {v}")
        for name, v in sorted(snap["gauges"].items()):
            head(name, "gauge")
            lines.append(f"{prefix}{name} {v}")
        for name, st in sorted(snap["histograms"].items()):
            head(name, "summary")
            lines.append(f"{prefix}{name}_count {st['count']}")
            lines.append(f"{prefix}{name}_sum {st['sum']}")
            for q in ("p50", "p99"):
                if st.get(q) is not None:
                    head(f"{name}_{q}", "gauge")
                    lines.append(f"{prefix}{name}_{q} {st[q]}")
        return "\n".join(lines) + "\n"


_HELP_CACHE = {"loaded": False, "help": {}}


def _metric_help(name):
    """Help text for one metric, parsed (once, lazily) from the
    docs/observability.md catalog tables — the single source of
    truth the lint rules enforce metric names against.  Returns None
    when the docs are absent (installed without docs) or the name is
    a derived one (``_p50``/``_p99`` quantiles inherit nothing)."""
    if not _HELP_CACHE["loaded"]:
        _HELP_CACHE["loaded"] = True
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "docs", "observability.md")
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line.startswith("|") or "`" not in line:
                        continue
                    cells = [c.strip() for c in
                             line.strip("|").split("|")]
                    if len(cells) < 3:
                        continue
                    names = re.findall(r"`([^`]+)`", cells[0])
                    text = " ".join(cells[-1].replace("`", "")
                                    .split())
                    for n in names:
                        _HELP_CACHE["help"].setdefault(n, text)
        except OSError:
            pass
    return _HELP_CACHE["help"].get(name)


_REGISTRY = MetricRegistry()


def get_registry():
    return _REGISTRY


def counter(name):
    """Process-wide counter, or the shared no-op when disabled."""
    if not enabled():
        return NULL_METRIC
    return _REGISTRY.counter(name)


def gauge(name):
    if not enabled():
        return NULL_METRIC
    return _REGISTRY.gauge(name)


def histogram(name, max_samples=512):
    if not enabled():
        return NULL_METRIC
    return _REGISTRY.histogram(name, max_samples=max_samples)


def snapshot():
    return _REGISTRY.snapshot()


def prometheus_text():
    return _REGISTRY.prometheus_text()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """No-op span: the disabled-mode (and re-enterable) singleton."""

    __slots__ = ()
    elapsed = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """Times one wall-clock section into the registry histogram
    ``span_<name>_seconds`` and, when the profiler is running, into
    its chrome://tracing stream (category 'span') so step phases and
    per-op events share a timeline.  Host-side timing only — never
    reads a device value.  The last measured duration stays readable
    as ``.elapsed`` so a fit loop can feed the per-step timeline
    splits to :class:`AnomalyWatch` without re-timing anything."""

    __slots__ = ("name", "_t0", "elapsed")

    def __init__(self, name):
        self.name = name
        self._t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        t1 = time.perf_counter()
        self.elapsed = t1 - self._t0
        _REGISTRY.histogram(
            f"span_{self.name}_seconds").observe(self.elapsed)
        prof = _profiler()
        if prof is not None and prof.running:
            prof.add_event(self.name, self._t0, t1, category="span")
        self._t0 = None
        return False


def _profiler():
    # lazy: profiler.py never imports telemetry at module level, so
    # this direction stays cycle-free; cache after first resolve
    global _PROF
    if _PROF is None:
        from . import profiler as _p
        _PROF = _p._profiler
    return _PROF


_PROF = None


def span(name):
    """``with telemetry.span("data_wait"): ...`` — see :class:`_Span`.
    Returns the shared no-op span when telemetry is disabled."""
    if not enabled():
        return NULL_SPAN
    return _Span(name)


# ---------------------------------------------------------------------------
# emitter
# ---------------------------------------------------------------------------


class TelemetryEmitter:
    """Background flusher: every ``interval`` seconds append one JSONL
    snapshot line to ``path`` (rotated to ``path + '.1'`` past
    ``max_bytes``) and atomically replace the Prometheus textfile
    ``path + '.prom'`` (temp + ``os.replace``, so a scraper never
    reads a torn file).  ``stop()`` performs a final flush so
    short-lived runs still leave a complete record."""

    def __init__(self, path=None, interval=None, registry=None,
                 max_bytes=None):
        self.path = path or get_env("MXTPU_TELEMETRY_FILE") or None
        self.interval = float(
            interval if interval is not None
            else get_env("MXTPU_TELEMETRY_INTERVAL"))
        self.registry = registry or _REGISTRY
        self.max_bytes = int(
            max_bytes if max_bytes is not None
            else get_env("MXTPU_TELEMETRY_MAX_MB") * 1024 * 1024)
        self.flushes = 0
        self._stop = threading.Event()
        self._thread = None
        self._flush_lock = threading.Lock()
        self._atexit = False

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        """Spawn the flusher daemon (no-op without a path or when
        telemetry is disabled); returns self.  Registers an atexit
        final flush for THIS emitter: a directly-constructed emitter
        on a short-lived process (bench run, spawned worker) would
        otherwise lose the last partial interval — the daemon thread
        dies with the interpreter mid-wait, never flushing.
        ``stop()`` is idempotent, so an emitter stopped explicitly
        just re-flushes a final complete record at exit."""
        if self.path is None or not enabled() or self.running:
            return self
        if not self._atexit:
            import atexit
            atexit.register(self.stop)
            self._atexit = True
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.flush()
                except OSError:
                    pass    # target dir vanished mid-teardown

        self._thread = threading.Thread(
            target=loop, daemon=True, name="mxtpu-telemetry-emitter")
        self._thread.start()
        return self

    def flush(self):
        """One snapshot -> JSONL append (+rotation) + prom rewrite."""
        if self.path is None:
            return None
        snap = self.registry.snapshot()
        line = json.dumps(snap, sort_keys=True)
        with self._flush_lock:
            self._rotate_if_needed(len(line) + 1)
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
            self._write_prom()
            self.flushes += 1
        return snap

    def _rotate_if_needed(self, incoming):
        if self.max_bytes <= 0:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming > self.max_bytes:
            os.replace(self.path, self.path + ".1")

    def _write_prom(self):
        """Atomic textfile rewrite: a scraper (or a crash) never
        observes a partial exposition.  Reuses resilience's
        mkstemp-based temp+fsync+rename helper — a fixed tmp name
        would collide under concurrent writers and leak on a failed
        serialize (sync_dir=False: freshness-based like heartbeats,
        staleness after power loss is moot)."""
        from . import resilience
        resilience._replace_with_bytes(
            self.path + ".prom",
            self.registry.prometheus_text().encode(), sync_dir=False)

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)
        if self.path is not None and enabled():
            try:
                self.flush()
            except OSError:
                pass


_EMITTER_LOCK = threading.Lock()
_EMITTER = {"obj": None, "atexit": False}


def _emitter_path():
    """Resolve the JSONL target: ``MXTPU_TELEMETRY_FILE``, suffixed
    ``.rank<N>`` for nonzero-rank workers — the launcher exports one
    path to every worker, and concurrent emitters on a shared file
    would race the rotation and tear each other's textfile.  Rank 0
    (and single-process runs) keep the bare path."""
    path = get_env("MXTPU_TELEMETRY_FILE") or None
    if path is None:
        return None
    try:
        rank = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)
    except ValueError:
        rank = 0
    return f"{path}.rank{rank}" if rank > 0 else path


def start_emitter(path=None, interval=None):
    """Start the process-wide emitter (idempotent for the same path;
    a new path stops the old emitter and re-targets — the same
    contract as resilience.start_heartbeat).  Registers an atexit
    final flush, so even a run shorter than the flush interval
    leaves a complete JSONL + textfile record.  Returns the emitter,
    or None when disabled / no path configured."""
    if not enabled():
        return None
    path = path or _emitter_path()
    if path is None:
        return None
    with _EMITTER_LOCK:
        cur = _EMITTER["obj"]
        if cur is not None and cur.running:
            if cur.path == path:
                return cur
            cur.stop()
        if not _EMITTER["atexit"]:
            import atexit
            atexit.register(stop_emitter)
            _EMITTER["atexit"] = True
        em = TelemetryEmitter(path=path, interval=interval)
        em.start()
        _EMITTER["obj"] = em
        return em


def maybe_start_emitter():
    """Fit-loop hook: start the emitter iff telemetry is on and
    ``MXTPU_TELEMETRY_FILE`` is set.  Steady-state cost when already
    running (or disabled): an env read and a lock-free check.

    Also the training-side hook for the flight recorder's signal
    dump (no-op unless ``MXTPU_TRACE_DUMP`` is set): fit loops,
    gluon Trainers, and dist.init all pass through here, so a hung
    training worker killed by the launcher leaves a post-mortem just
    like a serving engine does."""
    if not enabled():
        return None
    try:
        from . import tracing
        tracing.install_signal_dump()
    except Exception:
        pass
    cur = _EMITTER["obj"]
    if cur is not None and cur.running and cur.path == _emitter_path():
        return cur
    return start_emitter()


def stop_emitter():
    """Stop the process-wide emitter (final flush included)."""
    with _EMITTER_LOCK:
        em, _EMITTER["obj"] = _EMITTER["obj"], None
    if em is not None:
        em.stop()


# ---------------------------------------------------------------------------
# online anomaly watchdog
# ---------------------------------------------------------------------------


def _median(data):
    """Median of a pre-sorted list."""
    n = len(data)
    mid = n // 2
    if n % 2:
        return data[mid]
    return 0.5 * (data[mid - 1] + data[mid])


class AnomalyWatch:
    """Online regression detector over per-step timeline splits and
    serving latencies (docs/observability.md "Introspection plane").

    Each component (``data_wait`` / ``forward_backward`` /
    ``optimizer`` / ``host_sync``, or serving ``ttft`` /
    ``token_latency``) keeps a rolling window
    (``MXTPU_ANOMALY_WINDOW``) whose median + MAD form the baseline;
    an observation scoring above ``MXTPU_ANOMALY_THRESHOLD`` MADs
    over the median — after ``MXTPU_ANOMALY_MIN_STEPS`` warmup
    samples — opens an **episode**, attributed to the dominant
    drifting component.  Exactly one ``anomaly`` trace event and one
    ``anomaly_detections_total`` increment fire per episode;
    hysteresis (``MXTPU_ANOMALY_COOLDOWN`` consecutive calm samples
    to close) keeps a sustained regression from flapping.  Because
    regressed samples still enter the window, a *permanent* shift
    eventually becomes the new baseline and the episode closes on
    its own — the watchdog flags changes, it does not alarm forever.

    Everything is host-side float arithmetic under one short lock —
    zero device syncs, safe on the step/decode path."""

    def __init__(self, group="train", window=None, threshold=None,
                 min_samples=None, cooldown=None):
        self.group = group
        self.window = int(window if window is not None
                          else get_env("MXTPU_ANOMALY_WINDOW"))
        self.threshold = float(
            threshold if threshold is not None
            else get_env("MXTPU_ANOMALY_THRESHOLD"))
        self.min_samples = int(
            min_samples if min_samples is not None
            else get_env("MXTPU_ANOMALY_MIN_STEPS"))
        self.cooldown = int(cooldown if cooldown is not None
                            else get_env("MXTPU_ANOMALY_COOLDOWN"))
        self.episodes = 0
        self._hist = {}         # component -> deque(maxlen=window)
        self._seen = {}         # component -> total samples fed
        self._open = None       # episode dict while one is open
        self._calm = 0          # consecutive calm samples while open
        self._last_scores = {}
        self._lock = threading.Lock()

    def observe(self, sample):
        """Feed one observation (``{component: seconds}``; partial
        dicts fine — serving feeds ``ttft`` and ``token_latency`` on
        different calls).  Returns the episode dict when this sample
        OPENED one (the caller already got its single emission),
        else None."""
        if not enabled():
            return None
        scores = {}
        with self._lock:
            for comp, v in sample.items():
                v = float(v)
                hist = self._hist.get(comp)
                if hist is None:
                    hist = self._hist[comp] = deque(
                        maxlen=self.window)
                seen = self._seen.get(comp, 0)
                if seen >= self.min_samples and len(hist) >= 2:
                    data = sorted(hist)
                    med = _median(data)
                    mad = _median(sorted(abs(x - med)
                                         for x in data))
                    # noise floor: a near-flat baseline must not
                    # turn scheduler jitter into infinite scores
                    floor = max(mad, 0.05 * abs(med), 1e-9)
                    scores[comp] = ((v - med) / floor, v, med)
                hist.append(v)
                self._seen[comp] = seen + 1
            episode = self._step_episode(scores)
        if episode is not None:
            counter("anomaly_detections_total").inc()
            from . import tracing
            tracing.trace_event(
                "anomaly", group=self.group,
                component=episode["component"],
                score=episode["score"], value=episode["value"],
                median=episode["median"],
                episode=episode["episode"])
        return episode

    def _step_episode(self, scores):
        """Episode state machine (caller holds the lock).  Returns a
        copy of the episode dict exactly when one newly opens."""
        self._last_scores = {c: round(s[0], 3)
                             for c, s in scores.items()}
        hot = {c: s for c, s in scores.items()
               if s[0] >= self.threshold}
        if self._open is None:
            if not hot:
                return None
            comp = max(hot, key=lambda c: hot[c][0])
            score, value, med = hot[comp]
            self.episodes += 1
            self._calm = 0
            self._open = {"component": comp,
                          "score": round(score, 3), "value": value,
                          "median": med, "episode": self.episodes,
                          "samples": 1}
            return dict(self._open)
        self._open["samples"] += 1
        if hot:
            self._calm = 0
            comp = max(hot, key=lambda c: hot[c][0])
            if hot[comp][0] > self._open["score"]:
                # attribution tracks the dominant drifting component
                self._open.update(
                    component=comp, score=round(hot[comp][0], 3),
                    value=hot[comp][1], median=hot[comp][2])
        else:
            self._calm += 1
            if self._calm >= self.cooldown:
                self._open = None
                self._calm = 0
        return None

    def verdicts(self):
        """Host-side verdict snapshot for ``healthz``."""
        with self._lock:
            return {"group": self.group,
                    "anomalous": self._open is not None,
                    "episodes": self.episodes,
                    "open": dict(self._open) if self._open else None,
                    "scores": dict(self._last_scores)}


_ANOMALY_LOCK = threading.Lock()
_ANOMALY = {}


def anomaly_watch(group="train"):
    """Process-wide get-or-create :class:`AnomalyWatch` per feed
    group (``train`` step splits, ``serving`` latency feeds)."""
    with _ANOMALY_LOCK:
        w = _ANOMALY.get(group)
        if w is None:
            w = _ANOMALY[group] = AnomalyWatch(group=group)
        return w


def anomaly_verdicts():
    """Every group's verdicts (for ``healthz``); {} when nothing has
    been fed yet."""
    with _ANOMALY_LOCK:
        watches = list(_ANOMALY.values())
    return {w.group: w.verdicts() for w in watches}


def reset_anomaly_for_tests():
    """Drop all watch state (test isolation)."""
    with _ANOMALY_LOCK:
        _ANOMALY.clear()


# ---------------------------------------------------------------------------
# heartbeat ride-along
# ---------------------------------------------------------------------------


def heartbeat_payload():
    """Compact one-line JSON snapshot appended to the per-worker
    heartbeat file by ``resilience._beat`` (line 1 stays the bare
    timestamp, so mtime-based monitors and old parsers are
    untouched).  ``tools/launch.py`` reads these to aggregate ranks.
    Empty string when telemetry is disabled.

    Each beat first refreshes the tracing layer's memory gauges
    (host RSS + device live/peak bytes attributed to params /
    optimizer / KV pools / workspace — metadata reads only, no
    device syncs), so per-rank memory and the compile-event counters
    ride the same channel launch.py already monitors."""
    if not enabled():
        return ""
    try:
        from . import tracing
        tracing.update_memory_gauges()
    except Exception:
        pass    # memory sampling must never silence the heartbeat
    return json.dumps(_REGISTRY.snapshot(), sort_keys=True)


# ---------------------------------------------------------------------------
# fork safety
# ---------------------------------------------------------------------------


def _after_fork_in_child():
    """Fresh locks in a forked child: a lock another parent thread
    held at the fork would stay held forever in the child.  The
    emitter thread does not survive the fork; its slot is cleared so
    the child never flushes the parent's file."""
    global _EMITTER_LOCK, _ANOMALY_LOCK
    _REGISTRY._lock = threading.Lock()
    for m in list(_REGISTRY._metrics.values()):
        m._lock = threading.Lock()
    _EMITTER_LOCK = threading.Lock()
    _EMITTER["obj"] = None
    _ANOMALY_LOCK = threading.Lock()
    for w in list(_ANOMALY.values()):
        w._lock = threading.Lock()


os.register_at_fork(after_in_child=_after_fork_in_child)
