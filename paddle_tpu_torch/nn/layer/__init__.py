"""``paddle_tpu_torch.nn.layer`` (counterpart of ``paddle_tpu/nn/layer``):
the activation, common, loss, convolution, normalization, pooling,
recurrent and transformer layers, the containers, and the MoE layer."""

from .activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .base import Layer, building, params_from_numpy  # noqa: F401
from .common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unflatten,
    Unfold, Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .containers import LayerList, Sequential  # noqa: F401
from .conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose)
from .loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .moe import MoELayer  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool2D)
from .rnn import (  # noqa: F401
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell)
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)

__all__ = [n for n in dir() if n[:1].isupper()] + ["building",
                                                   "params_from_numpy"]
