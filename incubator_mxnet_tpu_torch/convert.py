"""Carry weights from the JAX package's models into the port's.

``load_gluon_params(block, arrays)`` fills a Gluon block (ResNet, any
``gluon.Block``) from ``{name: array}``, e.g. the JAX net's
``{k: p.data().asnumpy() for k, p in net.collect_params().items()}``,
BatchNorm's running stats included.  Names match after each net's own
prefix is stripped, so two nets built in one process (``resnetv10_``,
``resnetv11_``) still match.  The ``.params`` file
(``save_parameters`` / ``load_parameters``) is the other way across.

For the TransformerLM:
``wts`` is the nested dict of numpy arrays that the JAX model's
``_decode_weights()`` returns (the tests take it with
``jax.tree_util.tree_map(np.asarray, net._decode_weights())``):
``embed``, ``pos``, ``layers[i].{ln1,qkv,proj,ln2}`` with
``{up,down}`` or, for an MoE layer, ``moe`` (router weight, stacked
expert up weight and bias, down weight and bias), ``ln_f``, ``head``.
Both packages keep the same layouts (Dense weights are (out, in)), so
each array is copied as it is.  This module imports
neither JAX nor the JAX package: it reads plain arrays.

Arrays of the ``nd`` surface need no function here: they cross between
the packages as numpy arrays (``nd.array(x.asnumpy(), ctx=...)``),
through DLPack (``nd.from_dlpack``), or as files, since ``nd.save`` and
``nd.load`` keep the JAX package's npz format.
"""
import numpy as np
import torch

from .context import as_device

__all__ = ["load_reference_weights", "load_gluon_params"]


def _src_prefix(names):
    """The source net's own prefix: the first name's text up to its
    first "_" (a top-level block's prefix is ``<alias><count>_``), if
    every name starts with it; else none."""
    names = list(names)
    head = names[0].split("_", 1)[0] + "_" if names else ""
    if "_" in names[0] and all(n.startswith(head) for n in names):
        return head
    return ""


def load_gluon_params(block, arrays, ctx=None):
    """Copy ``arrays`` ({name: array-like}) into ``block``'s parameters;
    returns the block.  A name is matched after stripping the source
    net's prefix from it (``_src_prefix``) and ``block.prefix`` from the
    block's own.  A parameter without storage is made on ``ctx`` (None:
    the card); one with storage keeps its device unless ``ctx`` is
    given.  Raises ``ValueError`` on a name the block has and ``arrays``
    lacks, or a shape mismatch."""
    src_prefix = _src_prefix(arrays)
    src = {k[len(src_prefix):]: v for k, v in arrays.items()}
    own = block.collect_params()
    keys = {name: name[len(block.prefix):]
            if name.startswith(block.prefix) else name for name in own}
    missing = [name for name, key in keys.items() if key not in src]
    if missing:
        raise ValueError(f"arrays lack {len(missing)} parameters of the "
                         f"block: {missing[:5]}")
    for name, p in own.items():
        arr = torch.from_numpy(np.array(src[keys[name]], copy=True))
        shape = p.shape
        if shape is not None and all(shape) \
                and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the "
                             f"block has {tuple(shape)}")
        device = as_device(ctx) if ctx is not None else p._target(None)
        if p._allocated() and p._var.device != device:
            p.reset_ctx(device)
        p.set_data(arr.to(device=device, dtype=p._tdtype))
    return block


def load_reference_weights(model, wts):
    """Copy ``wts`` into ``model``'s parameters; returns the model.
    Raises ``ValueError`` on a missing key or a shape mismatch (a dense
    layer against an MoE one among them), and ``NotImplementedError`` on
    int8 ``{q, s}`` leaves, which the port does not carry."""
    with torch.no_grad():
        _copy(model._decode_params(), wts, "wts")
    return model


def _copy(dst, src, path):
    if isinstance(dst, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path}: expected a dict, got "
                             f"{type(src).__name__}")
        missing = sorted(set(dst) - set(src))
        if missing:
            raise ValueError(f"{path}: missing {missing}")
        for key, sub in dst.items():
            _copy(sub, src[key], f"{path}[{key!r}]")
    elif isinstance(dst, (list, tuple)):
        if len(src) != len(dst):
            raise ValueError(f"{path}: {len(src)} entries, the model "
                             f"has {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy(d, s, f"{path}[{i}]")
    else:
        if isinstance(src, dict):
            raise NotImplementedError(
                f"{path}: int8 {{q, s}} weights are not ported yet")
        arr = np.array(src, dtype=np.float32)
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{path}: shape {arr.shape}, the model has "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))
