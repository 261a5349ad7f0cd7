"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``)."""

from __future__ import annotations

from ... import nn
from ._utils import refuse_pretrained


class AlexNet(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are.  The classifier's two dropouts draw from
    ``core.rng``."""

    def __init__(self, num_classes=1000, device=None):
        super().__init__()
        self.num_classes = num_classes
        with nn.building(device):
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
                nn.MaxPool2D(3, 2))
            self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                    nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
                    nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    """The reference ignores ``pretrained``; the port refuses it, as the
    reference's other families do."""
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
