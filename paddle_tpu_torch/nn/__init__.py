"""``paddle_tpu_torch.nn`` (counterpart of ``paddle_tpu/nn``): the gradient
clips, the layers, functionals and initializers that the vision families
train through (ROADMAP A8a), and ``MoELayer`` (ROADMAP A7b).  The rest of
``nn`` waits for ROADMAP A8b."""

from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .layer import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D, AlphaDropout,
    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, Conv1D, Conv2D, Conv3D, Dropout, Dropout2D, Dropout3D,
    Flatten, Identity, Layer, LayerList, Linear, MaxPool1D, MaxPool2D,
    MaxPool3D, MoELayer, ReLU, ReLU6, Sequential, Swish, building)
