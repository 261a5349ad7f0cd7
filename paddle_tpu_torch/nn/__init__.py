"""``paddle_tpu_torch.nn`` (counterpart of ``paddle_tpu/nn``): the gradient
clips only, until the rest of ``nn`` is ported (ROADMAP A8)."""

from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
