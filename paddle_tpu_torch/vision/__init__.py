"""``paddle_tpu_torch.vision`` (counterpart of ``paddle_tpu/vision``): the
model zoo (``vision.models``) for now."""
