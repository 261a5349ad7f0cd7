"""``paddle_tpu_torch.nn.layer`` (counterpart of ``paddle_tpu/nn/layer``):
the layers the vision families build (ROADMAP A8a) and the MoE layer
(ROADMAP A7b)."""

from .activation import ReLU, ReLU6, Swish  # noqa: F401
from .base import Layer, building  # noqa: F401
from .common import (  # noqa: F401
    AlphaDropout, Dropout, Dropout2D, Dropout3D, Flatten, Identity, Linear)
from .containers import LayerList, Sequential  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .moe import MoELayer  # noqa: F401
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D  # noqa: F401
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
