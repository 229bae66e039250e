"""Gluon convolution and pooling layers (twin of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``): Conv1-3D,
Conv1-3DTranspose, Max/AvgPool1-3D, GlobalMax/AvgPool1-3D, on NC(D)HW
data.  ``in_channels=0`` defers the weight's input channels to the
first forward (``ops/shape_hooks.py``); ``ceil_mode`` is the pooling
op's "full" convention.
"""
from ..block import HybridBlock
from .basic_layers import _set_shapes

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding,
                 dilation, groups, layout, in_channels=0,
                 activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 ndim=2, transpose=False, output_padding=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._ndim = ndim
        self._activation = activation
        self._use_bias = use_bias
        self._transpose = transpose
        self._output_padding = _tup(output_padding, ndim)
        with self.name_scope():
            if transpose:
                wshape = (in_channels, channels // groups) + self._kernel
            else:
                wshape = (channels, in_channels // max(groups, 1)
                          if in_channels else 0) + self._kernel
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer)
            else:
                self.bias = None

    def shape_from_input(self, x):
        op = "Deconvolution" if self._transpose else "Convolution"
        _set_shapes(self, op, x,
                    dict(num_filter=self._channels, num_group=self._groups,
                         kernel=self._kernel), ["weight"])

    def hybrid_forward(self, F, x, weight, bias=None):
        if self._transpose:
            out = F.Deconvolution(
                x, weight, bias, kernel=self._kernel,
                stride=self._strides, pad=self._padding,
                dilate=self._dilation, adj=self._output_padding,
                num_filter=self._channels, num_group=self._groups,
                no_bias=not self._use_bias)
        else:
            out = F.Convolution(
                x, weight, bias, kernel=self._kernel,
                stride=self._strides, pad=self._padding,
                dilate=self._dilation, num_filter=self._channels,
                num_group=self._groups, no_bias=not self._use_bias)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


def _make_conv(name, ndim, transpose):
    class _C(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     dilation=1, groups=1, layout=None,
                     output_padding=0, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            super().__init__(channels, kernel_size, strides, padding,
                             dilation, groups, layout, in_channels,
                             activation, use_bias, weight_initializer,
                             bias_initializer, ndim=ndim,
                             transpose=transpose,
                             output_padding=output_padding, **kwargs)
    _C.__name__ = name
    _C.__qualname__ = name
    _C.__doc__ = (f"{name}: {ndim}-D {'transposed ' if transpose else ''}"
                  "convolution layer.")
    return _C


Conv1D = _make_conv("Conv1D", 1, False)
Conv2D = _make_conv("Conv2D", 2, False)
Conv3D = _make_conv("Conv3D", 3, False)
Conv1DTranspose = _make_conv("Conv1DTranspose", 1, True)
Conv2DTranspose = _make_conv("Conv2DTranspose", 2, True)
Conv3DTranspose = _make_conv("Conv3DTranspose", 3, True)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode,
                 global_pool, pool_type, ndim, **kwargs):
        super().__init__(**kwargs)
        self._kernel = _tup(pool_size, ndim)
        self._stride = _tup(strides if strides is not None
                            else pool_size, ndim)
        self._pad = _tup(padding, ndim)
        self._global = global_pool
        self._pool_type = pool_type
        self._convention = "full" if ceil_mode else "valid"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, kernel=self._kernel, stride=self._stride,
                         pad=self._pad, pool_type=self._pool_type,
                         global_pool=self._global,
                         pooling_convention=self._convention)


def _make_pool(name, ndim, pool_type, global_pool):
    if global_pool:
        class _P(_Pool):
            def __init__(self, layout=None, **kwargs):
                super().__init__(1, 1, 0, False, True, pool_type, ndim,
                                 **kwargs)
    else:
        class _P(_Pool):
            def __init__(self, pool_size=2, strides=None, padding=0,
                         layout=None, ceil_mode=False, **kwargs):
                super().__init__(pool_size, strides, padding, ceil_mode,
                                 False, pool_type, ndim, **kwargs)
    _P.__name__ = name
    _P.__qualname__ = name
    _P.__doc__ = f"{name}: {pool_type} pooling over {ndim} axes."
    return _P


MaxPool1D = _make_pool("MaxPool1D", 1, "max", False)
MaxPool2D = _make_pool("MaxPool2D", 2, "max", False)
MaxPool3D = _make_pool("MaxPool3D", 3, "max", False)
AvgPool1D = _make_pool("AvgPool1D", 1, "avg", False)
AvgPool2D = _make_pool("AvgPool2D", 2, "avg", False)
AvgPool3D = _make_pool("AvgPool3D", 3, "avg", False)
GlobalMaxPool1D = _make_pool("GlobalMaxPool1D", 1, "max", True)
GlobalMaxPool2D = _make_pool("GlobalMaxPool2D", 2, "max", True)
GlobalMaxPool3D = _make_pool("GlobalMaxPool3D", 3, "max", True)
GlobalAvgPool1D = _make_pool("GlobalAvgPool1D", 1, "avg", True)
GlobalAvgPool2D = _make_pool("GlobalAvgPool2D", 2, "avg", True)
GlobalAvgPool3D = _make_pool("GlobalAvgPool3D", 3, "avg", True)
