"""The JAX repository's four Pallas user kernels, as hand-written CUDA
kernels on the port's ``rtc`` facade.

The JAX repository keeps them outside its package, in a test, an example
and a tool.  The port keeps them here, so that its tests and
``chip_smoke.py`` hold the same four:

=========================  ===========================================
``scale``                  ``tests/test_rtc.py:20``, o = x * alpha
``addone``                 ``tests/test_rtc.py:93``, o = x + 1 over
                           8-row tiles
``fused_scale_shift_relu``  ``examples/custom_pallas_kernel.py:27``,
                           o = max(alpha * x + beta, 0)
``scale_shift``            ``tools/flash_compile_check.py:90``,
                           o = x * alpha + beta
=========================  ===========================================

Each source is ``csrc/rtc/<name>.cu``; ``kernel(name)`` wraps it in
``rtc.compile_kernel`` with its plain PyTorch version, and ``scale`` and
``fused_scale_shift_relu`` have the JAX versions' VJPs.  ``train_step``
is the path that ``chip_smoke.py`` drives at full width: the eager loop
of ``examples/custom_pallas_kernel.py`` grown to an SGD step.
"""
import functools
import math
from pathlib import Path

import torch

from . import autograd, rtc
from . import ndarray as nd

__all__ = ["NAMES", "SOURCES", "kernel", "reference", "scale_vjp",
           "fused_scale_shift_relu_vjp", "register_scale_shift_relu",
           "train_step"]

SOURCES = Path(__file__).resolve().parent / "csrc" / "rtc"
NAMES = ("scale", "addone", "fused_scale_shift_relu", "scale_shift")
BLOCK = 256
MAX_BLOCKS = 132 * 8      # 8 resident blocks of 256 threads per H100 SM
ROWS_PER_TILE = 8         # addone's tile, the Pallas BlockSpec's rows
SCALE_VEC = 4             # float4s a thread of scale moves per pass
GRID_X = 2 ** 31 - 1      # the card's limit on gridDim.x


def _like(x, **_):
    return rtc.ShapeDtype(tuple(x.shape), x.dtype)


def _numel(x, **_):
    return {"n": x.numel()}


def _grid_stride(x, **_):
    return (max(1, min(math.ceil(x.numel() / BLOCK), MAX_BLOCKS)),)


def _scale_grid(x, **_):
    """scale's grid: enough blocks to cover the array in one pass, each
    thread moving SCALE_VEC float4s (``csrc/rtc/scale.cu``)."""
    per_block = BLOCK * SCALE_VEC * 4
    return (max(1, min(math.ceil(x.numel() / per_block), GRID_X)),)


def _rows_cols(x, **_):
    if x.dim() != 2:
        raise ValueError(f"addone takes a 2-D array, got {tuple(x.shape)}")
    return {"rows": x.shape[0], "cols": x.shape[1]}


def _tiles(x, **_):
    """addone's grid: (blocks a tile, tiles); each tile of 8 rows is
    covered in one pass of blocks whose threads move one float4 each
    (``csrc/rtc/addone.cu``)."""
    tiles = math.ceil(x.shape[0] / ROWS_PER_TILE)
    if tiles > 65535:
        raise ValueError(f"addone: {x.shape[0]} rows is past the grid's "
                         f"{65535 * ROWS_PER_TILE}-row limit")
    per_block = BLOCK * 4
    return (max(1, math.ceil(ROWS_PER_TILE * x.shape[1] / per_block)),
            max(1, tiles))


def _scale(x, alpha):
    """Plain version of ``scale``: x * alpha."""
    return x * alpha


def _addone(x):
    """Plain version of ``addone``: x + 1."""
    return x + 1.0


def _fused_scale_shift_relu(x, alpha, beta):
    """Plain version of ``fused_scale_shift_relu``: relu(x * alpha +
    beta), rounded twice."""
    return torch.relu(x * alpha + beta)


def _scale_shift(x, alpha, beta):
    """Plain version of ``scale_shift``: x * alpha + beta, rounded
    twice."""
    return x * alpha + beta


_SPECS = {
    "scale": dict(
        signature="const float* x, float* o, float alpha, long long n",
        grid=_scale_grid, scalars=_numel, reference=_scale),
    "addone": dict(
        signature="const float* x, float* o, long long rows, "
                  "long long cols",
        grid=_tiles, scalars=_rows_cols, reference=_addone),
    "fused_scale_shift_relu": dict(
        signature="const float* x, float* o, float alpha, float beta, "
                  "long long n",
        grid=_grid_stride, scalars=_numel,
        reference=_fused_scale_shift_relu),
    "scale_shift": dict(
        signature="const float* x, float* o, float alpha, float beta, "
                  "long long n",
        grid=_grid_stride, scalars=_numel, reference=_scale_shift),
}


def reference(name):
    """The plain PyTorch version of kernel ``name``."""
    return _SPECS[name]["reference"]


@functools.cache
def kernel(name):
    """Kernel ``name`` as an ``rtc.compile_kernel`` callable (built at
    its first launch on a CUDA tensor)."""
    return rtc.compile_kernel((SOURCES / f"{name}.cu").read_text(), name,
                              out_shape=_like, block=(BLOCK,),
                              **_SPECS[name])


def scale_vjp():
    """``scale``'s VJP, g * alpha (``tests/test_rtc.py:28``)."""
    fn = kernel("scale")
    return (lambda x, alpha=2.0: (fn(x, alpha=alpha), None),
            lambda alpha, res, g: (g * alpha,))


def fused_scale_shift_relu_vjp():
    """The example's VJP (``examples/custom_pallas_kernel.py:37-44``):
    the mask comes from the output, g * (y > 0) * alpha."""
    fn = kernel("fused_scale_shift_relu")

    def fwd(x, alpha=1.0, beta=0.0):
        y = fn(x, alpha=alpha, beta=beta)
        return y, (y,)

    def bwd(alpha, beta, res, g):
        (y,) = res
        return (g * (y > 0) * alpha,)

    return fwd, bwd


def register_scale_shift_relu(name="scale_shift_relu"):
    """Register the fused kernel with its VJP as op ``name``, as the
    example does; returns the ``nd`` function."""
    return rtc.register(name, kernel("fused_scale_shift_relu"),
                        arg_names=["data"],
                        vjp=fused_scale_shift_relu_vjp())


def train_step(x, w, t, lr, alpha=2.0, beta=0.5, op="scale_shift_relu"):
    """One SGD step of the rtc path on NDArrays: h = op(x . w), loss =
    mean((h - t)^2), backward, then ``sgd_update`` writes w back
    (``out=w``).  ``w`` must have a gradient buffer (``attach_grad``);
    it holds this step's gradient afterwards.  Returns the loss."""
    f = getattr(nd, op)
    with autograd.record():
        h = f(nd.dot(x, w), alpha=alpha, beta=beta)
        loss = nd.mean(nd.square(h - t))
    loss.backward()
    nd.sgd_update(w, w.grad, lr=lr, out=w)
    return loss
