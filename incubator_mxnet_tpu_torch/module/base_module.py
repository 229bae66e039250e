"""BaseModule: the high-level symbolic training interface (twin of
``incubator_mxnet_tpu/module/base_module.py``; ref:
python/mxnet/module/base_module.py — fit:376, score, predict).

``fit`` runs the reference's loop: bind, init_params, init_optimizer,
then per batch ``forward_backward``, ``update`` and ``update_metric``,
the callbacks, and at each epoch's end the epoch callbacks and a
``score`` on the validation data.  Each step's sections are timed as
the JAX package times them, as telemetry spans (``data_wait``,
``forward_backward``, ``optimizer``, ``host_sync``: host clock only,
no synchronization added), which feed the anomaly watch and the
debugz ``train`` status.  ``checkpoint_prefix`` arms the divergence
rollback: when the step guard raises ``DivergedError``
(MXTPU_MAX_BAD_STEPS consecutive non-finite steps), ``fit`` restores the
newest ``prefix-NNNN.params`` that passes its CRC sidecar, the
optimizer's ``.states`` and the data iterator's ``.data`` companion
(``rollback_checkpoint``), then re-raises, as the JAX package's does:
the caller (or the launcher's restart loop) resumes from there.
"""
import logging
import time
import warnings

from .. import debugz, telemetry
from .. import initializer as init_mod
from .. import metric as metric_mod
from ..io.io import DataBatch
from ..model import BatchEndParam
from ..resilience import CheckpointCorruptError, DivergedError

__all__ = ["BaseModule"]


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    # ------------------------------------------------------------ abstract
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    # ------------------------------------------------------------ helpers
    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(None, arg_params, aux_params, allow_missing,
                         force_init, allow_extra)

    # ------------------------------------------------------------ score
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0):
        """Evaluate on a data iterator; the rows a padded batch wrapped
        around do not count."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            if pad:
                outs = [o[:o.shape[0] - pad] for o in self.get_outputs()]
                labels = [lb[:lb.shape[0] - pad]
                          for lb in eval_batch.label]
                eval_metric.update(labels, outs)
            else:
                self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch, nbatch, eval_metric, locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback is not None:
            param = BatchEndParam(epoch, nbatch, eval_metric, locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield self.get_outputs(), nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Outputs over a data iterator, the pad rows dropped, merged
        over batches (or one list per batch)."""
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if isinstance(eval_data, DataBatch):
            self.forward(eval_data, is_train=False)
            return self.get_outputs()
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            output_list.append([o[0:o.shape[0] - pad]
                                for o in self.get_outputs()])
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [nd.concatenate([o[i] for o in output_list], axis=0)
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    # ------------------------------------------------------------ fit
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_prefix=None):
        """Train on a data iterator for epochs ``begin_epoch`` to
        ``num_epoch`` (ref: base_module.py fit:376).  With
        ``checkpoint_prefix``, a ``DivergedError`` first rolls the
        module back to the newest valid checkpoint under that prefix
        (``rollback_checkpoint``), then propagates."""
        assert num_epoch is not None, "num_epoch must be given"
        telemetry.maybe_start_emitter()
        initializer = initializer or init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             epoch_end_callback, batch_end_callback,
                             eval_end_callback, eval_batch_end_callback,
                             begin_epoch, num_epoch, validation_metric,
                             monitor)
        except DivergedError:
            if checkpoint_prefix is not None:
                self.rollback_checkpoint(checkpoint_prefix,
                                         data_iter=train_data)
            raise

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    epoch_end_callback, batch_end_callback,
                    eval_end_callback, eval_batch_end_callback,
                    begin_epoch, num_epoch, validation_metric, monitor):
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            data_iter = iter(train_data)
            # per-step timeline (docs/observability.md): spans time
            # host-clock sections only, so no synchronization is added
            # beyond what a section already does (update_metric's
            # host pull)
            watch = telemetry.anomaly_watch("train")
            while True:
                sp_data = telemetry.span("data_wait")
                with sp_data:
                    data_batch = next(data_iter, None)
                if data_batch is None:
                    break
                if monitor is not None:
                    monitor.tic()
                sp_fb = telemetry.span("forward_backward")
                with sp_fb:
                    self.forward_backward(data_batch)
                sp_opt = telemetry.span("optimizer")
                with sp_opt:
                    self.update()
                sp_sync = telemetry.span("host_sync")
                with sp_sync:
                    self.update_metric(eval_metric, data_batch.label)
                split = {"data_wait": sp_data.elapsed,
                         "forward_backward": sp_fb.elapsed,
                         "optimizer": sp_opt.elapsed,
                         "host_sync": sp_sync.elapsed}
                watch.observe(split)
                debugz.publish("train", step=nbatch, epoch=epoch,
                               split=split)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch, nbatch, eval_metric,
                                          locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # ------------------------------------------------------------ rollback
    def rollback_checkpoint(self, prefix, data_iter=None):
        """Restore the newest valid ``prefix-NNNN.params`` checkpoint
        into this (bound) module after divergence: the parameters, the
        optimizer's ``.states`` companion (fresh state, with a warning,
        when it is missing or corrupt) and the ``.data`` companion into
        ``data_iter`` when it has ``load_state_dict``, so the stream
        resumes at the batch the checkpoint was taken at.  Returns the
        epoch restored, or None when no checkpoint validates (the
        parameters are left as they are)."""
        from ..context import cpu
        from ..model import (_checkpoint_epochs, checkpoint_companion_path,
                             load_checkpoint, load_data_state)
        epochs = _checkpoint_epochs(prefix)
        if not epochs:
            warnings.warn(
                f"divergence rollback: no checkpoints found under "
                f"prefix {prefix!r}; parameters left as-is",
                RuntimeWarning)
            return None
        newest = epochs[0][0]
        try:
            _, arg_params, aux_params, eff = load_checkpoint(
                prefix, newest, return_epoch=True, ctx=cpu())
        except CheckpointCorruptError as exc:
            warnings.warn(
                f"divergence rollback: no checkpoint under prefix "
                f"{prefix!r} validates ({exc}); parameters left "
                "as-is", RuntimeWarning)
            return None
        self.set_params(arg_params, aux_params, force_init=True)
        if self.optimizer_initialized and \
                hasattr(self, "load_optimizer_states"):
            states = checkpoint_companion_path(prefix, eff)
            try:
                self.load_optimizer_states(states)
            except (FileNotFoundError, CheckpointCorruptError) as exc:
                warnings.warn(
                    f"divergence rollback: optimizer states {states} "
                    f"could not be loaded ({exc}); continuing with "
                    "the diverged optimizer state replaced by the "
                    "restored weights only", RuntimeWarning)
        if data_iter is not None and \
                hasattr(data_iter, "load_state_dict"):
            load_data_state(prefix, eff, data_iter, strict=False)
        telemetry.counter("rollbacks_total").inc()
        warnings.warn(
            f"training diverged; rolled back to checkpoint epoch "
            f"{eff} of prefix {prefix!r} (params + optimizer + "
            "data-iterator state)", RuntimeWarning)
        return eff
