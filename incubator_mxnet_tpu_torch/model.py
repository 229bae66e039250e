"""Checkpoints, the kvstore choice and FeedForward (twin of
``incubator_mxnet_tpu/model.py``; ref: python/mxnet/model.py —
save_checkpoint/load_checkpoint, BatchEndParam, _create_kvstore:57,
FeedForward:408).

A checkpoint is the JAX package's files: ``prefix-symbol.json`` and
``prefix-NNNN.params`` (``arg:``/``aux:`` keys, npz) with its CRC32
sidecar, so either package loads the other's.  ``load_checkpoint``
falls back to the newest earlier epoch that validates when the one
asked for is corrupt (``MXTPU_CKPT_FALLBACK``, on unless set to 0).

``_create_kvstore`` resolves a kvstore spec as the reference does: on
one device None, ``'local'`` and ``'device'`` give no store (the updater
runs in the process); ``'tpu'``, a ``'dist_*'`` name or a ``KVStore``
give a store (``kvstore.py``), which runs the optimizer itself.
"""
import collections
import glob
import os
import pickle
import warnings

from . import kvstore as kvs
from . import ndarray as nd
from . import resilience
from . import symbol as sym
from .context import cpu

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "split_tagged_params", "checkpoint_companion_path",
           "save_data_state", "load_data_state", "FeedForward"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])

def _create_kvstore(kvstore, num_device, arg_params=None):
    """(ref: model.py:57) a kvstore spec as ``(kv, update_on_kvstore)``:
    None for None, and for a non-'dist' string other than 'tpu' on one
    device (the updater then runs in the process); else the store, which
    runs the optimizer itself unless a parameter has more than 16M
    entries."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and \
                kvstore != "tpu":
            return None, False
        kv = kvs.create(kvstore)
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    update_on_kvstore = True
    if arg_params:
        max_size = max(int(a.size) for a in arg_params.values())
        if max_size > 1024 * 1024 * 16:
            update_on_kvstore = False
    return kv, update_on_kvstore


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-NNNN.params`` (atomic, with its CRC32 sidecar)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)
    from . import telemetry
    telemetry.counter("checkpoint_saves_total").inc()


def split_tagged_params(save_dict):
    """Split a saved params dict on its ``arg:``/``aux:`` tags into
    (arg_params, aux_params).  Untagged keys (a raw ``nd.save`` of a
    param dict) count as args; other tags are ignored."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if not name:
            arg_params[k] = v
        elif tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def _checkpoint_epochs(prefix):
    """(epoch, path) of every ``prefix-N.params`` on disk, newest
    first; where a padded and an unpadded name claim one epoch, the
    padded one."""
    best = {}
    for p in glob.glob(f"{glob.escape(prefix)}-*.params"):
        stem = os.path.basename(p)[len(os.path.basename(prefix)) + 1:
                                   -len(".params")]
        if not stem.isdigit():
            continue
        epoch = int(stem)
        if epoch not in best or p == f"{prefix}-{epoch:04d}.params":
            best[epoch] = p
    return sorted(best.items(), reverse=True)


def _params_path(prefix, epoch):
    """The params file of ``epoch`` that exists: the padded name, else
    the on-disk scan's."""
    want = f"{prefix}-{epoch:04d}.params"
    if not os.path.exists(want):
        for cand, path in _checkpoint_epochs(prefix):
            if cand == epoch:
                return path
    return want


def checkpoint_companion_path(prefix, epoch, ext=".states"):
    """The per-epoch companion (optimizer ``.states``, ``.data``) next
    to the params file that exists for ``epoch``."""
    return _params_path(prefix, epoch)[:-len(".params")] + ext


def save_data_state(prefix, epoch, data_iter):
    """Pickle ``data_iter.state_dict()`` into ``prefix-NNNN.data``
    (atomic, CRC32 sidecar), so a restart resumes the stream at the
    batch it stopped at.  Returns the path."""
    state = data_iter.state_dict()
    path = f"{prefix}-{epoch:04d}.data"
    resilience.atomic_save(path, lambda f: pickle.dump(state, f))
    return path


def load_data_state(prefix, epoch, data_iter, strict=False):
    """Restore ``data_iter`` from the ``.data`` companion of ``epoch``.
    A missing or corrupt one warns and leaves the stream at the epoch
    start (the weights are intact), unless ``strict``.  True when the
    state was applied."""
    path = checkpoint_companion_path(prefix, epoch, ext=".data")
    try:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no data-state companion {path}")
        raw = resilience.read_validated_bytes(path)
        state = resilience.decode_or_corrupt(path,
                                             lambda: pickle.loads(raw))
    except (FileNotFoundError, resilience.CheckpointCorruptError) as exc:
        if strict:
            raise
        warnings.warn(f"data-pipeline state {path} could not be loaded "
                      f"({exc}); resuming the stream from the epoch "
                      "start", RuntimeWarning)
        return False
    data_iter.load_state_dict(state)
    return True


def _fallback_default():
    return os.environ.get("MXTPU_CKPT_FALLBACK", "1").lower() not in (
        "0", "false", "no", "off")


def load_checkpoint(prefix, epoch, fallback=None, return_epoch=False, *,
                    ctx=None):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays
    on ``ctx`` (None: the card).

    When the params file is corrupt (CRC32 mismatch or an undecodable
    archive), the newest earlier epoch that validates loads instead,
    with a warning naming both (``fallback``; default
    ``MXTPU_CKPT_FALLBACK``, on).  ``return_epoch=True`` appends the
    epoch that loaded, which per-epoch companions must follow."""
    if fallback is None:
        fallback = _fallback_default()
    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym.load(f"{prefix}-symbol.json")
    effective = epoch
    try:
        save_dict = nd.load(_params_path(prefix, epoch), ctx=ctx)
    except resilience.CheckpointCorruptError as exc:
        if not fallback:
            raise
        for cand, cand_path in _checkpoint_epochs(prefix):
            if cand >= epoch:
                continue
            try:
                save_dict = nd.load(cand_path, ctx=ctx)
            except resilience.CheckpointCorruptError:
                continue
            warnings.warn(
                f"checkpoint {prefix}-{epoch:04d}.params is corrupt "
                f"({exc}); falling back to newest valid epoch {cand}",
                RuntimeWarning)
            from . import telemetry
            telemetry.counter("checkpoint_fallbacks_total").inc()
            effective = cand
            break
        else:
            raise resilience.CheckpointCorruptError(
                f"checkpoint {prefix}-{epoch:04d}.params is corrupt and "
                "no earlier checkpoint validates") from exc
    arg_params, aux_params = split_tagged_params(save_dict)
    if return_epoch:
        return symbol, arg_params, aux_params, effective
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy estimator (ref: model.py FeedForward): fit, predict
    and score over numpy arrays or DataIters, a thin shell around
    ``Module``."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 optimizer="sgd", initializer=None,
                 numpy_batch_size=128, arg_params=None,
                 aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.optimizer_params = kwargs
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _as_iter(self, X, y=None, shuffle=False):
        import numpy as np
        from .io.io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        X = np.asarray(X)
        if y is not None:
            y = np.asarray(y, np.float32)
        return NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                len(X)),
                           shuffle=shuffle, label_name="softmax_label")

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, checkpoint_prefix=None):
        """Train a Module on (X, y) or an iterator.  ``checkpoint_prefix``
        arms the step sentinel's divergence rollback, as in
        ``BaseModule.fit``."""
        import logging
        from . import initializer as init_mod
        from .module import Module
        train = self._as_iter(X, y, shuffle=True)
        if isinstance(eval_data, tuple):
            eval_data = self._as_iter(*eval_data)
        mod = Module(self.symbol, context=self.ctx,
                     logger=logger or logging)
        self._module = mod
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback,
                kvstore=kvstore, optimizer=self.optimizer,
                optimizer_params=self.optimizer_params or None,
                initializer=self.initializer or init_mod.Uniform(0.01),
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch,
                checkpoint_prefix=checkpoint_prefix,
                # num_epoch is the END epoch (reference semantics)
                num_epoch=self.num_epoch if self.num_epoch is not None
                else self.begin_epoch + 1)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _bound_module(self, data_iter):
        from .io.io import DataDesc
        from .module import Module
        if self._module is not None and self._module.binded:
            return self._module
        if self.arg_params is None:
            raise RuntimeError("FeedForward: fit() or load() first")
        # loss heads keep their label argument; at inference it only
        # needs a shape, so bind a (batch,) desc per *_label argument
        batch = data_iter.provide_data[0].shape[0]
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("_label")]
        mod = Module(self.symbol, context=self.ctx,
                     label_names=label_names)
        mod.bind(data_shapes=data_iter.provide_data,
                 label_shapes=[DataDesc(n, (batch,))
                               for n in label_names] or None,
                 for_training=False)
        mod.set_params(self.arg_params, self.aux_params or {},
                       allow_extra=self.allow_extra_params)
        self._module = mod
        return mod

    def predict(self, X, num_batch=None):
        """Forward over X: numpy, one array per output (a list for a
        multi-output symbol)."""
        data_iter = self._as_iter(X)
        out = self._bound_module(data_iter).predict(data_iter,
                                                    num_batch=num_batch)
        if isinstance(out, list):
            outs = [o.asnumpy() for o in out]
            return outs[0] if len(outs) == 1 else outs
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None):
        data_iter = self._as_iter(X, y)
        return self._bound_module(data_iter).score(
            data_iter, eval_metric, num_batch=num_batch)[0][1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint; ``begin_epoch`` is the epoch
        that loaded (an earlier one after a corrupt-file fallback)."""
        symbol, arg_params, aux_params, effective = load_checkpoint(
            prefix, epoch, return_epoch=True, ctx=cpu())
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=effective,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", **kwargs):
        """Train in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer,
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore)
        return model
