"""``paddle_tpu_torch.tensor`` (counterpart of ``paddle_tpu/tensor``):
``manipulation``'s ``reshape``, ``flatten``, ``transpose`` and ``concat``
only, until the rest is ported (ROADMAP A8b)."""

from .manipulation import concat, flatten, reshape, transpose  # noqa: F401
