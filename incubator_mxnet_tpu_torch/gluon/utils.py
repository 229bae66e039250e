"""Gluon utilities (twin of ``incubator_mxnet_tpu/gluon/utils.py``):
split_data, split_and_load, clip_global_norm."""
import math

from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    takes the rest unless ``even_split``)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(f"batch {size} too small for {num_slice} slices")
    if even_split and size % num_slice != 0:
        raise ValueError(f"batch {size} not divisible by {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = size if i == num_slice - 1 else (i + 1) * step
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Slice a batch across devices, one slice per entry of
    ``ctx_list``."""
    from ..ndarray import array as nd_array
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their global 2-norm is at most
    ``max_norm``; returns the norm before scaling.  A non-finite norm
    (one bad gradient) with ``check_isfinite`` leaves the arrays as
    they are and warns: scaling by a non-finite factor would poison
    every array.  Callers test ``math.isfinite(norm)`` and skip the
    update."""
    import warnings
    total = 0.0
    for a in arrays:
        n = a.norm().asscalar()
        total += float(n) ** 2
    total = math.sqrt(total)
    if check_isfinite and not math.isfinite(total):
        warnings.warn(
            f"clip_global_norm: non-finite total norm ({total}); "
            "arrays left unscaled — check the norm and skip this "
            "update", RuntimeWarning)
        return total
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total
