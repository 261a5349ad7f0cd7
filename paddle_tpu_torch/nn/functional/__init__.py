"""``paddle_tpu_torch.nn.functional`` (counterpart of
``paddle_tpu/nn/functional``): what the vision families train through
(ROADMAP A8a); the rest waits for ROADMAP A8b."""

from .activation import relu, relu6, silu, softmax, swish  # noqa: F401
from .common import (  # noqa: F401
    alpha_dropout, dropout, dropout2d, dropout3d, linear)
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm  # noqa: F401
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
