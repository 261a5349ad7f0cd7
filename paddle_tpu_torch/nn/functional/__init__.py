"""``paddle_tpu_torch.nn.functional`` (counterpart of
``paddle_tpu/nn/functional``): what the vision families train through
(ROADMAP A8a), the normalization functionals, the transposed convs,
``fold``/``unfold``, adaptive max pooling and ``max_unpool2d``; the rest
waits for ROADMAP A8b-1."""

from .activation import relu, relu6, silu, softmax, swish  # noqa: F401
from .common import (  # noqa: F401
    alpha_dropout, dropout, dropout2d, dropout3d, linear)
from .conv import (  # noqa: F401
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose, fold, unfold)
from .extras import max_unpool2d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import (  # noqa: F401
    batch_norm, batch_stats_over, group_norm, instance_norm, layer_norm,
    local_response_norm, normalize)
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
