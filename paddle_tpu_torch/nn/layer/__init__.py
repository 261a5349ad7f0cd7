"""``paddle_tpu_torch.nn.layer`` (counterpart of ``paddle_tpu/nn/layer``):
the layers the vision families build (ROADMAP A8a), the normalization
layers, the transposed convs, adaptive max pooling and ``MaxUnPool2D``,
and the MoE layer (ROADMAP A7b)."""

from .activation import ReLU, ReLU6, Swish  # noqa: F401
from .base import Layer, building  # noqa: F401
from .common import (  # noqa: F401
    AlphaDropout, Dropout, Dropout2D, Dropout3D, Flatten, Identity, Linear)
from .containers import LayerList, Sequential  # noqa: F401
from .conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose)
from .moe import MoELayer  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool2D)
