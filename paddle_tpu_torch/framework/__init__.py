"""``paddle_tpu_torch.framework`` (counterpart of ``paddle_tpu/framework``):
``io`` (``save``/``load``).  ``param_attr`` waits for ROADMAP A8b-1's
third slice."""
