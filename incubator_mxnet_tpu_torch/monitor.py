"""Monitor: per-op output statistics for numeric debugging (twin of
``incubator_mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py
Monitor:33, the executor callback of graph_executor.cc:121).

``Monitor.install()`` arms a global hook that the imperative dispatch
(``nd``'s ``imperative_invoke``) calls with every op's outputs, so eager
``nd`` ops and non-hybridized Gluon are observed; ``install(executor)``
(or ``Module.install_monitor``) also sets the executor's monitor
callback, so every op node of its graph goes through the stat function
in each armed batch (``tic`` .. ``toc``).  An armed batch is a
telemetry span (``monitor_armed``), and ``toc`` counts
``monitor_armed_batches_total`` and ``monitor_stat_rows_total``, as in
the JAX package.
"""
import re

import numpy as np

from . import telemetry

__all__ = ["Monitor", "nonfinite_count", "observe_op", "active"]

_active_monitor = None


def _default_stat(x):
    """Mean |x| over the finite elements (nan if none)."""
    x = np.asarray(x)
    if x.dtype.kind not in "fc":
        return float(np.abs(x).mean()) if x.size else float("nan")
    finite = np.isfinite(x)
    if not finite.any():
        return float("nan")
    return float(np.abs(x[finite]).mean())


def nonfinite_count(x):
    """Stat function counting non-finite elements: the first op whose
    row is nonzero is the one that made the NaN/Inf."""
    x = np.asarray(x)
    if x.dtype.kind not in "fc":
        return 0
    return int(x.size - np.count_nonzero(np.isfinite(x)))


class Monitor:
    """Collects (batch, op_name, stat) rows while armed: every
    ``interval``-th batch, for op names ``pattern`` matches."""

    def __init__(self, interval=1, stat_func=None, pattern=".*",
                 sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._span = None
        self._exes = []

    def install(self, target=None):
        """Arm the global dispatch hook; an Executor ``target`` also gets
        the per-op monitor callback."""
        global _active_monitor
        _active_monitor = self
        if target is not None:
            target.set_monitor_callback(self._observe)
            if target not in self._exes:
                self._exes.append(target)
        return self

    def uninstall(self):
        global _active_monitor
        if _active_monitor is self:
            _active_monitor = None
        for exe in self._exes:
            exe.set_monitor_callback(None)
        self._exes = []

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
            # armed batches are slower: the span makes "the debug tap
            # was on here" visible in the telemetry timeline
            if self._span is not None:
                # the prior armed batch aborted between tic and toc:
                # close its span now so it still lands in the timeline
                self._span.__exit__(None, None, None)
            self._span = telemetry.span("monitor_armed")
            self._span.__enter__()
        self.step += 1

    def toc(self):
        """The rows of the armed batch (empty when not armed)."""
        if not self.activated:
            return []
        self.activated = False
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        res, self.queue = self.queue, []
        telemetry.counter("monitor_armed_batches_total").inc()
        telemetry.counter("monitor_stat_rows_total").inc(len(res))
        return sorted(res, key=lambda r: r[1]) if self.sort else res

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat}")

    def _observe(self, name, out_arrays):
        if not self.activated or not self.pattern.match(name):
            return
        for i, arr in enumerate(out_arrays):
            label = name if len(out_arrays) == 1 else f"{name}_out{i}"
            self.queue.append((self.step, label,
                               self.stat_func(arr.asnumpy())))


def observe_op(name, out_arrays):
    """The dispatch hook (called by ``imperative_invoke``)."""
    if _active_monitor is not None:
        _active_monitor._observe(name, out_arrays)


def active():
    """Whether an installed monitor is armed (between tic and toc)."""
    return _active_monitor is not None and _active_monitor.activated
