"""Training callbacks (twin of ``incubator_mxnet_tpu/callback.py``; ref:
python/mxnet/callback.py — Speedometer, do_checkpoint,
log_train_metric, module_checkpoint, ProgressBar).

``Speedometer`` logs samples per second and publishes it, with the
epoch and batch, as telemetry gauges (``throughput_samples_per_sec``,
``epoch``, ``nbatch``), as the JAX package does."""
import logging
import time

from . import telemetry

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "module_checkpoint", "log_train_metric"]


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving checkpoints (``model.save_checkpoint``)
    every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        from .model import save_checkpoint
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving ``mod``'s checkpoint (and optimizer
    states) every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Logs throughput (samples/s) and the metric every ``frequent``
    batches; ``speed`` keeps the last rate.  The window is the batch
    count since the last report, so a first report at a nonzero
    ``nbatch`` is not inflated."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.tic_count = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            self.tic_count = count
            return
        if count % self.frequent != 0:
            return
        window = count - self.tic_count
        elapsed = time.time() - self.tic
        if window <= 0 or elapsed <= 0:
            return
        speed = self.speed = window * self.batch_size / elapsed
        telemetry.gauge("throughput_samples_per_sec").set(speed)
        telemetry.gauge("epoch").set(param.epoch)
        telemetry.gauge("nbatch").set(count)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()
        self.tic_count = count


class ProgressBar:
    """A text progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
