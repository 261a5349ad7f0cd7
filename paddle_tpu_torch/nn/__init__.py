"""``paddle_tpu_torch.nn`` (counterpart of ``paddle_tpu/nn``): the gradient
clips, the layers, functionals and initializers that the vision families
train through (ROADMAP A8a), the normalization layers with
``SyncBatchNorm``, the transposed convs, adaptive max pooling,
``MaxUnPool2D``, and ``MoELayer`` (ROADMAP A7b).  The rest of ``nn``
waits for ROADMAP A8b-1."""

from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .layer import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AlphaDropout,
    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose, Dropout, Dropout2D, Dropout3D, Flatten, GroupNorm,
    Identity, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, Layer,
    LayerList, LayerNorm, Linear, LocalResponseNorm, MaxPool1D, MaxPool2D,
    MaxPool3D, MaxUnPool2D, MoELayer, ReLU, ReLU6, Sequential, SpectralNorm,
    Swish, SyncBatchNorm, building)
