"""ctypes binding of the native JPEG batch decoder (twin of
``incubator_mxnet_tpu/image/native_dec.py``; ref role:
src/io/iter_image_recordio_2.cc decode threads).

``src/imgdec/imgdec.cc`` (libjpeg, its own thread pool, fork-safe: the
v3 ABI) is built with ``g++`` at first use into the package's
``_build/host/`` (``utils/host_build.py``).  Where it cannot be built
(no ``jpeglib.h`` or libjpeg), ``available()`` is False, ``why()``
says why, and the callers decode with PIL.  Host-side only: no torch.
"""
import ctypes

import numpy as np

from ..utils import host_build

__all__ = ["available", "decode_batch", "why"]

_SIGNATURES = {
    "imgdec_last_error": ([], ctypes.c_char_p),
    "imgdec_batch_err": ([
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
}


def _native_lib():
    return host_build.load("imgdec", _SIGNATURES)


def why():
    """Why the native decoder is not available here (None if it is)."""
    return None if available() else host_build.why("imgdec")


def available():
    return _native_lib() is not None


def decode_batch(raws, out_hw, resize_short=0, mirror=None,
                 mean=None, std=None, nthreads=8, out=None):
    """Decode a list of JPEG byte strings into (n, 3, H, W) float32.

    mirror: optional per-image bool array; mean/std: optional
    3-vectors applied as (px - mean) / std.  Raises on any decode
    failure (fail loudly: a corrupt record must not train as zeros).
    """
    lib = _native_lib()
    if lib is None:
        raise RuntimeError("native image decoder unavailable")
    n = len(raws)
    oh, ow = out_hw
    if out is None:
        out = np.empty((n, 3, oh, ow), np.float32)
    bufs = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(r), ctypes.c_void_p)
          for r in raws])
    sizes = (ctypes.c_int64 * n)(*[len(r) for r in raws])
    mir = None
    if mirror is not None:
        mirror = np.ascontiguousarray(mirror, np.uint8)
        mir = mirror.ctypes.data_as(ctypes.c_void_p)
    mvec = svec = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        mvec = mean.ctypes.data_as(ctypes.c_void_p)
    if std is not None:
        std = np.ascontiguousarray(std, np.float32)
        svec = std.ctypes.data_as(ctypes.c_void_p)
    # per-call error buffer: a concurrent iterator's next batch can't
    # clobber this batch's message (unlike the imgdec_last_error()
    # global)
    err = ctypes.create_string_buffer(512)
    failed = lib.imgdec_batch_err(
        bufs, sizes, n, oh, ow, int(resize_short), mir, mvec, svec,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(nthreads), err, len(err))
    if failed:
        raise ValueError(
            f"native decode failed for {failed}/{n} images: "
            f"{err.value.decode(errors='replace')}")
    return out
