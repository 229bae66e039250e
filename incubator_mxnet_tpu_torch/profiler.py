"""Profiler: per-op timing and a chrome://tracing dump (twin of
``incubator_mxnet_tpu/profiler.py``; ref: src/engine/profiler.h
OprExecStat:39 / Profiler:80 / DumpProfile:107, python/mxnet/profiler.py,
MXNET_PROFILER_AUTOSTART).

Two layers, as the reference splits its own op stats from nvprof:
- framework layer: every imperative op dispatch (``nd`` and the
  executor's eager path through ``imperative_invoke``) is timed on the
  host, ``mode='sync'`` synchronizing the card after each op so the
  time covers its kernels, and dumped as chrome://tracing JSON by
  ``dump_profile()``;
- device layer: ``start_xla_trace``/``stop_xla_trace`` keep the JAX
  package's names and wrap ``torch.profiler`` (CPU and CUDA
  activities), writing its Chrome trace into ``logdir``.

A dump ends with the telemetry registry's counters and gauges as
counter ('C') events, and ``telemetry.span`` sections land in the same
stream (category 'span').  The serving engine's per-request async
events land on named synthetic lanes (``SERVE_QUEUE_LANE``, and
``SERVE_SLOT_LANE0 + slot``).
"""
import json
import os
import threading
import time

from .engine import wait
from .resilience import _replace_with_bytes

__all__ = ["set_config", "set_state", "dump_profile", "pause",
           "resume", "start_xla_trace", "stop_xla_trace", "Profiler"]

# synthetic thread ids ("lanes") for async request streams: chrome
# tracing wants a tid per row, and the serving engine's per-request
# b/e events should render on named serving rows next to the span
# stream, not interleaved with real thread ids
SERVE_QUEUE_LANE = 900000
SERVE_SLOT_LANE0 = 900001


class Profiler:
    """Singleton collecting OprExecStat-style events."""

    def __init__(self):
        self.filename = "profile.json"
        self.mode = "coarse"  # 'coarse' | 'sync' (block per op)
        self.state = "stop"
        self._events = []
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._tls = threading.local()
        self._lanes = {}    # synthetic tid -> display name ('M')

    # ------------------------------------------------------------ api
    def set_config(self, filename="profile.json", mode="coarse",
                   **_ignored):
        self.filename = filename
        self.mode = mode

    def set_state(self, state):
        if state not in ("run", "stop"):
            raise ValueError(f"state must be 'run' or 'stop', got "
                             f"{state!r}")
        self.state = state

    @property
    def running(self):
        return self.state == "run"

    def add_event(self, name, t_start, t_end, category="operator"):
        with self._lock:
            self._events.append({
                "name": name, "cat": category, "ph": "X",
                "ts": (t_start - self._t0) * 1e6,
                "dur": (t_end - t_start) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
            })

    def add_async_event(self, name, aid, ph, category="serving",
                        lane=None, args=None):
        """Record one chrome-tracing *async* event: ``ph`` is ``"b"``
        (begin) or ``"e"`` (end), paired by ``(cat, id, name)``.
        Async events span dispatch sites — the serving engine opens a
        request's ``queue_wait`` in ``submit()`` and closes it at
        admission, iterations apart — which ``X`` duration events
        cannot express.  ``lane`` places the event on a synthetic,
        named timeline row (see :meth:`set_lane_name`)."""
        if ph not in ("b", "e"):
            raise ValueError(f"async phase must be 'b'/'e' ({ph!r})")
        ev = {"name": name, "cat": category, "ph": ph, "id": str(aid),
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": os.getpid(),
              "tid": lane if lane is not None
              else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def set_lane_name(self, lane, name):
        """Name a synthetic lane (tid); dumped as ``thread_name``
        ``M`` metadata so Perfetto shows e.g. 'serve slot 0' instead
        of a bare number."""
        with self._lock:
            self._lanes[int(lane)] = str(name)

    def _meta_events(self, events):
        """chrome-tracing metadata ('M') events: name the process and
        every thread that recorded an event, so the timeline rows
        read 'mxtpu rank N' / real thread names instead of bare
        ids."""
        pid = os.getpid()
        rank = os.environ.get("MXTPU_WORKER_RANK", "0")
        out = [{"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"mxtpu rank {rank}"}}]
        names = {t.ident: t.name for t in threading.enumerate()}
        with self._lock:
            names.update(self._lanes)
        tids = {e["tid"] for e in events if "tid" in e}
        for tid in sorted(tids):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": names.get(tid,
                                                   f"thread-{tid}")}})
        return out

    def _counter_events(self):
        """Telemetry registry counters/gauges as chrome-tracing
        counter ('C') events stamped at dump time, so spans and
        counters land in ONE timeline (docs/observability.md)."""
        from . import telemetry
        if not telemetry.enabled():
            return []
        snap = telemetry.snapshot()
        ts = (time.perf_counter() - self._t0) * 1e6
        pid = os.getpid()
        events = []
        for kind in ("counters", "gauges"):
            for name, value in sorted(snap[kind].items()):
                events.append({"name": name, "cat": "telemetry",
                               "ph": "C", "ts": ts, "pid": pid,
                               "args": {name: value}})
        return events

    def dump(self, finished=True):
        """Write the trace.  Concurrent-safe: dumps are serialized
        (two racing dumps can no longer interleave writes into the
        same file, where the empty loser used to clobber the winner
        and lose its events), the snapshot-and-clear is atomic under
        the event lock (an add_event racing the file write lands in
        the retained buffer for the *next* dump instead of being
        dropped), and the file itself is written temp + rename so a
        reader never sees a torn JSON document."""
        with self._dump_lock:
            with self._lock:
                events = self._events
                if finished:
                    self._events = []
                else:
                    events = list(events)
            data = {"traceEvents":
                    self._meta_events(events) + events
                    + self._counter_events()}
            _replace_with_bytes(self.filename, json.dumps(data).encode())
        return self.filename

    # -------------------------------------------------- op dispatch hook
    def record_op(self, name, outs):
        """Called from imperative_invoke when running."""
        if self.mode == "sync":
            wait(outs)
        t0 = getattr(self._tls, "pending_t0", None)
        self.add_event(name, t0 if t0 is not None
                       else time.perf_counter(), time.perf_counter())

    def op_start(self):
        # per-thread start time: ops dispatched concurrently from the
        # threaded data pipeline must not cross-read each other's t0
        self._tls.pending_t0 = time.perf_counter()


_profiler = Profiler()


def set_config(**kwargs):
    """(ref: profiler.py profiler_set_config)"""
    _profiler.set_config(**kwargs)


def set_state(state="stop"):
    """'run' or 'stop' (ref: profiler.py profiler_set_state)."""
    _profiler.set_state(state)


def pause():
    _profiler.set_state("stop")


def resume():
    _profiler.set_state("run")


def dump_profile():
    """Write chrome://tracing JSON (ref: MXDumpProfile)."""
    return _profiler.dump()


_device_trace = {"prof": None, "logdir": None, "count": 0}


def start_xla_trace(logdir="/tmp/xla_trace"):
    """Start a device-level trace: ``torch.profiler`` over the CPU and,
    with a card, CUDA activities.  ``stop_xla_trace`` writes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _device_trace["prof"] is not None:
        raise RuntimeError("a device trace is running already")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _device_trace.update(prof=prof, logdir=logdir)
    return logdir


def stop_xla_trace():
    """Stop the device trace and write it as Chrome trace JSON into its
    ``logdir``; returns the file's path."""
    prof = _device_trace["prof"]
    if prof is None:
        raise RuntimeError("no device trace is running "
                           "(start_xla_trace first)")
    prof.stop()
    _device_trace["prof"] = None
    _device_trace["count"] += 1
    os.makedirs(_device_trace["logdir"], exist_ok=True)
    path = os.path.join(_device_trace["logdir"],
                        f"trace-{os.getpid()}-{_device_trace['count']}.json")
    prof.export_chrome_trace(path)
    return path


# autostart parity (ref: MXNET_PROFILER_AUTOSTART)
if os.environ.get("MXTPU_PROFILER_AUTOSTART", "") == "1":
    _profiler.set_state("run")
