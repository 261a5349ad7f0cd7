"""``paddle_tpu_torch.nn`` (counterpart of ``paddle_tpu/nn``): the gradient
clips, the layers, functionals and initializers (ROADMAP A8a and A8b-1's
first slice: activations, losses, common layers, ``MultiHeadAttention``
and the ``Transformer*`` layers over the flash kernels), the normalization
layers with ``SyncBatchNorm``, and ``MoELayer`` (ROADMAP A7b).
``params_from_numpy`` loads the reference's numpy weights by name.
``nn.utils``, ``nn.decode``, ``rnn`` and ``quant`` wait for ROADMAP
A8b-1's later slices."""

from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer import Layer, building, params_from_numpy  # noqa: F401
