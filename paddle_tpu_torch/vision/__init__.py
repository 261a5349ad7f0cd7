"""``paddle_tpu_torch.vision`` (counterpart of ``paddle_tpu/vision``): the
ResNet family and LeNet (``vision.models``) for now."""
