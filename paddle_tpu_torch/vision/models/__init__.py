"""``paddle_tpu_torch.vision.models`` (counterpart of
``paddle_tpu/vision/models``): the ten families of the reference's zoo
(ResNet, LeNet, AlexNet, VGG, SqueezeNet, MobileNet V1/V2, GoogLeNet,
InceptionV3, DenseNet, ShuffleNetV2), and ``params_from_numpy``
(``nn.params_from_numpy``, kept here under its first name), which carries
the reference's weights and running statistics across."""

from __future__ import annotations

from ...nn.layer.base import params_from_numpy  # noqa: F401
from ._utils import ConvBNReLU  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2)
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x4d,
    wide_resnet50_2, wide_resnet101_2)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_swish, shufflenet_v2_x0_25,
    shufflenet_v2_x0_33, shufflenet_v2_x0_5, shufflenet_v2_x1_0,
    shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401


__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext101_32x4d", "AlexNet", "alexnet", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2", "GoogLeNet", "googlenet", "InceptionV3",
           "inception_v3", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet264", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "ConvBNReLU",
           "params_from_numpy"]
