"""SqueezeNet, DenseNet, MobileNet and Inception-v3 (twin of
``incubator_mxnet_tpu/gluon/model_zoo/vision/others.py``; ref:
python/mxnet/gluon/model_zoo/vision/{squeezenet,densenet,mobilenet,
inception}.py).

The same blocks built in the same order, so parameter names and shapes
equal the JAX package's (Inception3 keeps its abbreviated topology);
the layers run through cuDNN (``ops/nn.py``) on the card;
``pretrained=True`` loads from the local store (``model_store.py``)."""
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "DenseNet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "Inception3", "inception_v3"]


def _pretrained(net, pretrained, name, ctx=None, root=None):
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, name, ctx=ctx, root=root)
    return net


# ---------------------------------------------------------------- squeeze
class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
        self.expand1 = nn.Conv2D(expand1x1, 1, activation="relu")
        self.expand3 = nn.Conv2D(expand3x3, 3, padding=1,
                                 activation="relu")

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.Concat(self.expand1(x), self.expand3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, 7, 2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(16, 64), (16, 64), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(32, 128), (48, 192), (48, 192),
                             (64, 256)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, 3, 2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(16, 64), (16, 64)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(32, 128), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(48, 192), (48, 192), (64, 256),
                             (64, 256)]:
                    self.features.add(_Fire(s, e, e))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, 1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kw):
    return _pretrained(SqueezeNet("1.0", **kw), pretrained,
                       "squeezenet1.0", ctx, root)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kw):
    return _pretrained(SqueezeNet("1.1", **kw), pretrained,
                       "squeezenet1.1", ctx, root)


# ---------------------------------------------------------------- dense
class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, 1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, 3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                for _ in range(num_layers):
                    self.features.add(_DenseLayer(growth_rate, bn_size,
                                                  dropout))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                    self.features.add(nn.Conv2D(num_features // 2, 1,
                                                use_bias=False))
                    self.features.add(nn.AvgPool2D(2, 2))
                    num_features //= 2
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _make_dense(n):
    def f(pretrained=False, ctx=None, root=None, **kw):
        a, b, c = densenet_spec[n]
        return _pretrained(DenseNet(a, b, c, **kw), pretrained,
                           f"densenet{n}", ctx, root)
    f.__name__ = f"densenet{n}"
    return f


densenet121 = _make_dense(121)
densenet161 = _make_dense(161)
densenet169 = _make_dense(169)
densenet201 = _make_dense(201)


# ---------------------------------------------------------------- mobile
class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                       + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6
                    + [1024] * 2]
        strides = [1, 2] * 3 + [1] * 5 + [2, 1]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(int(32 * multiplier), 3, 2, 1,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            for dwc, c, s in zip(dw_channels, channels, strides):
                # depthwise
                self.features.add(nn.Conv2D(dwc, 3, s, 1, groups=dwc,
                                            use_bias=False,
                                            in_channels=dwc))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                # pointwise
                self.features.add(nn.Conv2D(c, 1, use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _make_mobile(mult, suffix):
    def f(pretrained=False, ctx=None, root=None, **kw):
        return _pretrained(MobileNet(mult, **kw), pretrained,
                           f"mobilenet{suffix}", ctx, root)
    f.__name__ = f"mobilenet{suffix}"
    return f


mobilenet1_0 = _make_mobile(1.0, "1_0")
mobilenet0_75 = _make_mobile(0.75, "0_75")
mobilenet0_5 = _make_mobile(0.5, "0_5")
mobilenet0_25 = _make_mobile(0.25, "0_25")


# ---------------------------------------------------------------- incep
def _conv_bn(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channel axis."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._branches = []

    def add(self, block):
        self._branches.append(block)
        self.register_child(block)

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self._branches]
        return F.Concat(*outs, dim=1)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_conv_bn(64, 1))
    b2 = nn.HybridSequential(prefix="")
    b2.add(_conv_bn(48, 1))
    b2.add(_conv_bn(64, 5, pad=2))
    out.add(b2)
    b3 = nn.HybridSequential(prefix="")
    b3.add(_conv_bn(64, 1))
    b3.add(_conv_bn(96, 3, pad=1))
    b3.add(_conv_bn(96, 3, pad=1))
    out.add(b3)
    b4 = nn.HybridSequential(prefix="")
    b4.add(nn.AvgPool2D(3, 1, 1))
    b4.add(_conv_bn(pool_features, 1))
    out.add(b4)
    return out


class Inception3(HybridBlock):
    """Inception v3 (299x299) — abbreviated faithful topology."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(_conv_bn(32, 3, 2))
            f.add(_conv_bn(32, 3))
            f.add(_conv_bn(64, 3, pad=1))
            f.add(nn.MaxPool2D(3, 2))
            f.add(_conv_bn(80, 1))
            f.add(_conv_bn(192, 3))
            f.add(nn.MaxPool2D(3, 2))
            f.add(_make_A(32, "A1_"))
            f.add(_make_A(64, "A2_"))
            f.add(_make_A(64, "A3_"))
            # reduction
            red = _Concurrent(prefix="B_")
            red.add(_conv_bn(384, 3, 2))
            b = nn.HybridSequential(prefix="")
            b.add(_conv_bn(64, 1))
            b.add(_conv_bn(96, 3, pad=1))
            b.add(_conv_bn(96, 3, 2))
            red.add(b)
            bp = nn.HybridSequential(prefix="")
            bp.add(nn.MaxPool2D(3, 2))
            red.add(bp)
            f.add(red)
            for _ in range(2):
                f.add(_make_A(192, None))
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Dropout(0.5))
            f.add(nn.Flatten())
            self.features = f
            self.output = nn.Dense(classes)

    def shape_from_input(self, *i):
        pass

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kw):
    return _pretrained(Inception3(**kw), pretrained, "inception_v3",
                       ctx, root)
