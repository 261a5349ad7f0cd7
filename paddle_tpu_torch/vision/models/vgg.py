"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``)."""

from __future__ import annotations

from ... import nn
from ._utils import refuse_pretrained

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    """The feature stack of ``cfg`` ("M" a 2x2 max pool, an int a 3x3 conv
    of that many channels, with a BatchNorm under ``batch_norm``), built
    on the enclosing ``nn.building`` scope's device."""
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """``features`` from :func:`make_layers`; the head is built on
    ``device`` (default: the enclosing ``nn.building`` scope's, else
    ``cuda``, raising without a card)."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        with nn.building(device):
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, **kwargs):
    """The reference ignores ``pretrained``; the port refuses it, as the
    reference's other families do."""
    refuse_pretrained(pretrained)
    with nn.building(device) as dev:
        return VGG(make_layers(cfgs[cfg], batch_norm), device=dev, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
