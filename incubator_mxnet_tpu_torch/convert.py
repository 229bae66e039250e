"""Carry weights from the JAX package's TransformerLM into the port's.

``wts`` is the nested dict of numpy arrays that the JAX model's
``_decode_weights()`` returns (the tests take it with
``jax.tree_util.tree_map(np.asarray, net._decode_weights())``):
``embed``, ``pos``, ``layers[i].{ln1,qkv,proj,ln2,up,down}``, ``ln_f``,
``head``.  Both packages keep the same layouts (Dense weights are
(out, in)), so each array is copied as it is.  This module imports
neither JAX nor the JAX package: it reads plain arrays.

Arrays of the ``nd`` surface need no function here: they cross between
the packages as numpy arrays (``nd.array(x.asnumpy(), ctx=...)``),
through DLPack (``nd.from_dlpack``), or as files, since ``nd.save`` and
``nd.load`` keep the JAX package's npz format.
"""
import numpy as np
import torch

__all__ = ["load_reference_weights"]


def load_reference_weights(model, wts):
    """Copy ``wts`` into ``model``'s parameters; returns the model.
    Raises ``ValueError`` on a missing key or a shape mismatch, and
    ``NotImplementedError`` on MoE layers or int8 ``{q, s}`` leaves,
    which this slice does not carry."""
    with torch.no_grad():
        _copy(model._decode_params(), wts, "wts")
    return model


def _copy(dst, src, path):
    if isinstance(dst, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path}: expected a dict, got "
                             f"{type(src).__name__}")
        if "moe" in src:
            raise NotImplementedError(
                f"{path}: MoE layers are not ported yet")
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
