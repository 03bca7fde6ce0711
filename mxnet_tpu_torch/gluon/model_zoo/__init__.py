"""``mx.gluon.model_zoo``, MXNet's import path for the vision zoo
(counterpart of ``mxnet_tpu/gluon/model_zoo``; the models live in
``mxnet_tpu_torch.models.vision``)."""
from . import vision

__all__ = ["vision"]
