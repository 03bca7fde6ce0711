"""The vision model zoo (counterpart of ``mxnet_tpu.models.vision``, after
MXNet's ``gluon.model_zoo.vision``): the reference's 34 names in
``_models``, built by :func:`get_model`.  Weights are drawn by
``initialize`` (no pretrained files) or copied from the reference with
``utils.convert.load_numpy_params``, whose structural names both
packages share."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .mlp import MLP
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_25, mobilenet0_5,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_25,
                        mobilenet_v2_0_5, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

_models = {name: globals()[name] for name in (
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2",
    "alexnet",
    "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
    "squeezenet1_0", "squeezenet1_1",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
    "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
    "mobilenet_v2_0_25",
    "inception_v3")}


def get_model(name, **kwargs):
    """The zoo model ``name`` (case-insensitive) built with ``kwargs``;
    an unknown name raises ``ValueError``."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"model {name} not found; available: {sorted(_models)}")
    return _models[name](**kwargs)
