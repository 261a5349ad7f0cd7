"""DenseNet 121/161/169/201/264 (counterpart of
``paddle_tpu/vision/models/densenet.py``)."""

from __future__ import annotations

from ... import nn
from ...tensor.manipulation import concat
from ._utils import refuse_pretrained


class _DenseLayer(nn.Layer):
    def __init__(self, num_channels, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(num_channels)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_channels, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, num_channels, num_output):
        super().__init__()
        self.bn = nn.BatchNorm2D(num_channels)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(num_channels, num_output, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(kernel_size=2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseNet(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are.  ``dropout`` > 0 gives every dense layer a
    dropout, drawing from ``core.rng``."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None):
        super().__init__()
        num_init, growth, block_cfg = _CFG[layers]
        with nn.building(device):
            self.features = nn.Sequential(
                nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                          bias_attr=False),
                nn.BatchNorm2D(num_init), nn.ReLU(),
                nn.MaxPool2D(kernel_size=3, stride=2, padding=1))
            ch = num_init
            blocks = []
            for i, n in enumerate(block_cfg):
                for _ in range(n):
                    blocks.append(_DenseLayer(ch, growth, bn_size, dropout))
                    ch += growth
                if i != len(block_cfg) - 1:
                    blocks.append(_Transition(ch, ch // 2))
                    ch = ch // 2
            self.blocks = nn.Sequential(*blocks)
            self.bn_last = nn.BatchNorm2D(ch)
            self.relu_last = nn.ReLU()
            self.with_pool = with_pool
            self.num_classes = num_classes
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.relu_last(self.bn_last(self.blocks(self.features(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained, **kwargs):
    refuse_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
