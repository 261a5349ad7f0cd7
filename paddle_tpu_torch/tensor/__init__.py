"""``paddle_tpu_torch.tensor`` (counterpart of ``paddle_tpu/tensor``):
``manipulation.flatten`` only, until the rest is ported (ROADMAP A8b)."""

from .manipulation import flatten  # noqa: F401
