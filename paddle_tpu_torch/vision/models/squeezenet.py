"""SqueezeNet 1.0 and 1.1 (counterpart of
``paddle_tpu/vision/models/squeezenet.py``)."""

from __future__ import annotations

from ... import nn
from ...tensor.manipulation import concat
from ._utils import refuse_pretrained


class _Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, expand1, expand3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze, expand1, 1)
        self.expand3 = nn.Conv2D(squeeze, expand3, 3, padding=1)

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(s)),
                       self.relu(self.expand3(s))], axis=1)


class SqueezeNet(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with nn.building(device):
            if version == "1.0":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                    _Fire(128, 32, 128, 128),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                    _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(512, 64, 256, 256))
            elif version == "1.1":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 64, 3, stride=2, padding=1), nn.ReLU(),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                    nn.MaxPool2D(kernel_size=3, stride=2),
                    _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                    _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
            else:
                raise ValueError(f"unsupported version {version!r}")
            if num_classes > 0:
                self.drop = nn.Dropout(0.5)
                self.final_conv = nn.Conv2D(512, num_classes, 1)
                self.relu = nn.ReLU()
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.relu(self.final_conv(self.drop(x)))
        if self.with_pool:
            x = self.pool(x)
            if self.num_classes > 0:
                x = x.flatten(1)
        return x


def _squeezenet(version, pretrained, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
