"""AlexNet (twin of ``incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py``;
ref: python/mxnet/gluon/model_zoo/vision/alexnet.py).

The same HybridBlocks built in the same order, so parameter names and
shapes equal the JAX package's; ``pretrained=True`` loads from the
local store (``model_store.py``)."""
from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
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


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "alexnet", ctx=ctx, root=root)
    return net
