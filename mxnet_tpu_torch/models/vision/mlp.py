"""MNIST-scale MLP (counterpart of ``mxnet_tpu/models/vision/mlp.py``)."""
from ...gluon import nn
from ...gluon.block import HybridBlock

__all__ = ["MLP"]


class MLP(HybridBlock):
    def __init__(self, hidden=(128, 64), classes=10, activation="relu",
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        for h in hidden:
            self.body.add(nn.Dense(h, activation=activation))
        self.body.add(nn.Dense(classes))

    def forward(self, x):
        return self.body(x)
