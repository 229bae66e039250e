"""MFU / throughput gauge publisher on device time (twin of
``incubator_mxnet_tpu/perf/clock.py``).

``TrainPerfClock`` turns a per-step analytic cost (from the graph cost
model or a model's ``train_flops_per_token``) into the ``train_mfu`` /
``train_mbu`` / ``train_tokens_per_sec`` gauges.

The JAX clock divides a window's FLOPs by host wall time.  On a card
that reads far too high: a captured step's replay returns at once, so
the host can run many steps ahead of the device.  So on a CUDA device
this clock records a CUDA event at each window edge, on the current
stream (the one the steps run on), and turns a window into gauges only once its end event's
``query()`` says the device got there: the interval is
``start.elapsed_time(end)``, device time.  It never calls
``synchronize`` or reads a device value (``.item()``), so ticking it
every step adds no device-to-host sync.  A window still in flight is
resolved at a later tick, or by :meth:`poll`.  The first tick opens the
first window (the first call of a step is its warm-up and capture),
so a window's steps are the ticks after its start.  On the CPU it reads
``time.monotonic()`` as the JAX clock does.

Publication cadence: every ``MXTPU_PERF_INTERVAL`` ticks by default,
or exactly on the step sentinel's guard-interval read when the caller
passes its ``due`` flag.
"""
import collections
import time

from .. import telemetry
from ..utils.env import get_env
from . import device_db

__all__ = ["TrainPerfClock"]


def _cuda_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


class TrainPerfClock:
    """Publishes train-side MFU/MBU/throughput gauges from device time
    (host time on the CPU).

    flops_per_step / bytes_per_step: analytic cost of one full train
    step (already 3x-forward scaled).  tokens_per_step: for the
    throughput gauge.  device: the device the steps run on (default:
    the current context's).  All may be armed late via :meth:`arm`.
    """

    def __init__(self, flops_per_step=0.0, bytes_per_step=0.0,
                 tokens_per_step=0.0, device=None, dtype="bfloat16"):
        self._flops = float(flops_per_step)
        self._bytes = float(bytes_per_step)
        self._tokens = float(tokens_per_step)
        self._dtype = dtype
        self._device = None
        self._caps = None
        self._set_device(device)
        self._interval = max(1, get_env("MXTPU_PERF_INTERVAL"))
        self._ticks = 0
        self._win_steps = 0
        self._win_start = None         # event (card) or monotonic time
        self._pending = []             # card: [(start, end, steps)]
        self._new_event = _cuda_event
        # the newest resolved windows: (steps, seconds)
        self.windows = collections.deque(maxlen=64)
        self._g_mfu = telemetry.gauge("train_mfu")
        self._g_mbu = telemetry.gauge("train_mbu")
        self._g_tok = telemetry.gauge("train_tokens_per_sec")

    def _set_device(self, device):
        from ..context import as_device, current_context
        dev = as_device(device if device is not None
                        else current_context())
        self._device = dev
        self._caps = device_db.caps_for(dev)

    @property
    def on_card(self):
        return self._device.type == "cuda"

    def arm(self, flops_per_step=None, bytes_per_step=None,
            tokens_per_step=None, device=None):
        """Set/replace the analytic cost after construction."""
        if flops_per_step is not None:
            self._flops = float(flops_per_step)
        if bytes_per_step is not None:
            self._bytes = float(bytes_per_step)
        if tokens_per_step is not None:
            self._tokens = float(tokens_per_step)
        if device is not None:
            self._set_device(device)

    def _edge(self):
        """A window edge: a recorded event on the card, else now."""
        if not self.on_card:
            return time.monotonic()
        ev = self._new_event()
        ev.record()          # the current stream, where the steps run
        return ev

    def tick(self, due=None):
        """Count one step; close the window when ``due`` (or every
        MXTPU_PERF_INTERVAL ticks when ``due`` is None) and publish the
        windows the device has finished.  No device reads on any
        path."""
        self._ticks += 1
        if self._win_start is None:
            # the first tick opens the first window
            self._win_start = self._edge()
            return
        self._win_steps += 1
        if due is None:
            due = self._ticks % self._interval == 0
        if due and self._win_steps:
            end = self._edge()
            if self.on_card:
                self._pending.append((self._win_start, end,
                                      self._win_steps))
            else:
                self._publish(self._win_steps, end - self._win_start)
            self._win_start = end
            self._win_steps = 0
        self.poll()

    def poll(self):
        """Publish every closed window whose end event the device has
        reached (``query()``, no wait).  Returns how many are still in
        flight."""
        while self._pending:
            start, end, steps = self._pending[0]
            if not (end.query() and start.query()):
                break
            self._pending.pop(0)
            self._publish(steps, start.elapsed_time(end) / 1e3)
        return len(self._pending)

    def _publish(self, steps, seconds):
        if seconds <= 0.0 or steps <= 0:
            return
        self.windows.append((steps, seconds))
        rate = steps / seconds
        caps = self._caps
        if self._tokens:
            self._g_tok.set(self._tokens * rate)
        peak = caps.peak(self._dtype)
        if self._flops and peak:
            self._g_mfu.set(self._flops * rate / peak)
        if self._bytes and caps.hbm_bytes_per_s:
            self._g_mbu.set(self._bytes * rate
                            / caps.hbm_bytes_per_s)
