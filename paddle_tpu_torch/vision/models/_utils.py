"""Shared building blocks of the vision model zoo (counterpart of
``paddle_tpu/vision/models/_utils.py``)."""

from __future__ import annotations

from ... import nn

_NO_PRETRAINED = ("pretrained weights are unavailable (zero-egress build); "
                  "load a local state_dict instead")


def refuse_pretrained(pretrained):
    """Raise as the reference's constructors do for ``pretrained=True``:
    there are no weights to download."""
    if pretrained:
        raise ValueError(_NO_PRETRAINED)


class ConvBNReLU(nn.Layer):
    """conv → batch-norm → relu, the block the inception-family models
    repeat (one definition so the BatchNorm settings stay in sync)."""

    def __init__(self, in_ch, out_ch, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride, padding=padding,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))
