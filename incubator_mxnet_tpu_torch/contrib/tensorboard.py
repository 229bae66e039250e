"""TensorBoard bridge (twin of ``incubator_mxnet_tpu/contrib/tensorboard.py``;
ref: python/mxnet/contrib/tensorboard.py — ``LogMetricsCallback``,
which streams EvalMetric values into a summary writer so training
curves show up in TensorBoard).

Writer resolution order:
1. an explicit ``summary_writer`` object (anything with
   ``add_scalar(tag, value, step)``),
2. ``torch.utils.tensorboard.SummaryWriter`` (it needs the
   ``tensorboard`` package) writing real TF event files,
3. a JSONL fallback writing ``{"tag", "value", "step", "ts"}`` lines,
   with no dependency.

``log_telemetry`` writes the telemetry registry's gauges and counters
as scalars, as the JAX package does.
"""
import json
import os
import time

__all__ = ["LogMetricsCallback", "make_writer", "log_telemetry"]


class _JsonlWriter:
    """Dependency-free event log: one JSON object per scalar."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(
            logdir, f"events.{int(time.time())}.jsonl")
        self._f = open(self._path, "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def make_writer(logdir):
    """Best available summary writer for ``logdir``."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except Exception:
        return _JsonlWriter(logdir)


def log_telemetry(writer, snapshot=None, step=None):
    """Write a telemetry registry snapshot's gauges (and counters) as
    TensorBoard scalars, tagged ``telemetry/<name>``.

    ``snapshot`` defaults to a fresh ``telemetry.snapshot()``;
    ``step`` defaults to the snapshot's ``train_steps_total`` counter
    so successive calls land on the training-step axis.  Returns the
    number of scalars written — 0 with telemetry disabled."""
    from .. import telemetry
    if snapshot is None:
        if not telemetry.enabled():
            return 0
        snapshot = telemetry.snapshot()
    if step is None:
        step = int(snapshot.get("counters", {})
                   .get("train_steps_total", 0))
    written = 0
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        writer.add_scalar(f"telemetry/{name}", value, step)
        written += 1
    for name, value in sorted(snapshot.get("counters", {}).items()):
        writer.add_scalar(f"telemetry/{name}", value, step)
        written += 1
    return written


class LogMetricsCallback:
    """Batch-end callback streaming metric values to a writer.

    >>> cb = LogMetricsCallback('./logs', prefix='train')
    >>> mod.fit(it, batch_end_callback=cb, ...)
    >>> cb.close()          # or: with LogMetricsCallback(...) as cb:

    Same call contract as the reference's: invoked with a
    ``BatchEndParam``-style object carrying ``epoch``, ``nbatch``
    and ``eval_metric``.  Owns the writer it creates (closing it on
    close()/exit releases the underlying fd); an explicitly passed
    ``summary_writer`` stays the caller's to close.
    """

    def __init__(self, logging_dir, prefix=None,
                 summary_writer=None):
        self.prefix = prefix
        self.step = 0
        self._owns_writer = summary_writer is None
        self.writer = summary_writer or make_writer(logging_dir)

    def __call__(self, param):
        if self.writer is None:
            raise ValueError(
                "LogMetricsCallback was closed; create a new one "
                "for further logging")
        if param.eval_metric is None:
            return
        self.step += 1
        for name, value in self._pairs(param.eval_metric):
            tag = f"{self.prefix}-{name}" if self.prefix else name
            self.writer.add_scalar(tag, value, self.step)

    def close(self):
        w, self.writer = self.writer, None
        if w is not None and self._owns_writer and \
                hasattr(w, "close"):
            w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _pairs(metric):
        name, value = metric.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))
