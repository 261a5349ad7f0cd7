"""``paddle_tpu_torch.nn`` (counterpart of ``paddle_tpu/nn``): the gradient
clips, the layers, functionals and initializers (ROADMAP A8a and A8b-1's
first slice: activations, losses, common layers, ``MultiHeadAttention``
and the ``Transformer*`` layers over the flash kernels), the normalization
layers with ``SyncBatchNorm``, and ``MoELayer`` (ROADMAP A7b).
``params_from_numpy`` loads the reference's numpy weights by name.  The
recurrent layers (``layer/rnn.py``) and ``decode`` (``BeamSearchDecoder``,
``dynamic_decode``) came with the random surface (A8b-1's second slice);
``nn.utils`` and ``quant`` wait for its later slices."""

from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import Layer, building, params_from_numpy  # noqa: F401
