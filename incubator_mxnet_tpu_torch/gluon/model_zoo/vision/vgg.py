"""VGG 11/13/16/19, with and without BatchNorm (twin of
``incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py``; ref:
python/mxnet/gluon/model_zoo/vision/vgg.py).

Parameter names and shapes equal the JAX package's; ``pretrained=True``
loads from the local store (``model_store.py``)."""
from ... import nn
from ...block import HybridBlock

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], 3,
                                                padding=1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def shape_from_input(self, *inputs):
        pass

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None,
            **kwargs):
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        bn = "_bn" if kwargs.get("batch_norm") else ""
        load_pretrained(net, f"vgg{num_layers}{bn}", ctx=ctx,
                        root=root)
    return net


def _make(n, bn):
    def f(**kwargs):
        if bn:
            kwargs["batch_norm"] = True
        return get_vgg(n, **kwargs)
    f.__name__ = f"vgg{n}" + ("_bn" if bn else "")
    return f


vgg11, vgg13, vgg16, vgg19 = (_make(n, False) for n in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_make(n, True)
                                          for n in (11, 13, 16, 19))
