"""Inception v3 (counterpart of
``paddle_tpu/vision/models/inceptionv3.py``)."""

from __future__ import annotations

from ... import nn
from ...tensor.manipulation import concat
from ._utils import ConvBNReLU as _ConvBN
from ._utils import refuse_pretrained


def _cat(xs):
    return concat(xs, axis=1)


class _InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_feat):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(in_ch, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(kernel_size=3, stride=1,
                                             padding=1),
                                _ConvBN(in_ch, pool_feat, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class _InceptionB(nn.Layer):  # grid reduction 35->17
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _ConvBN(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                 _ConvBN(64, 96, 3, padding=1),
                                 _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class _InceptionC(nn.Layer):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 192, 1)
        self.b7 = nn.Sequential(_ConvBN(in_ch, c7, 1),
                                _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
                                _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(_ConvBN(in_ch, c7, 1),
                                 _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
                                 _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
                                 _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
                                 _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(kernel_size=3, stride=1,
                                             padding=1),
                                _ConvBN(in_ch, 192, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)])


class _InceptionD(nn.Layer):  # grid reduction 17->8
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_ch, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(_ConvBN(in_ch, 192, 1),
                                _ConvBN(192, 192, (1, 7), padding=(0, 3)),
                                _ConvBN(192, 192, (7, 1), padding=(3, 0)),
                                _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class _InceptionE(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 320, 1)
        self.b3_1 = _ConvBN(in_ch, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_1 = nn.Sequential(_ConvBN(in_ch, 448, 1),
                                   _ConvBN(448, 384, 3, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(kernel_size=3, stride=1,
                                             padding=1),
                                _ConvBN(in_ch, 192, 1))

    def forward(self, x):
        a = self.b3_1(x)
        b = self.b3d_1(x)
        return _cat([self.b1(x),
                     _cat([self.b3_a(a), self.b3_b(a)]),
                     _cat([self.b3d_a(b), self.b3d_b(b)]),
                     self.bp(x)])


class InceptionV3(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are.  The head's dropout draws from ``core.rng``."""

    def __init__(self, num_classes=1000, with_pool=True, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with nn.building(device):
            self.stem = nn.Sequential(
                _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
                _ConvBN(32, 64, 3, padding=1),
                nn.MaxPool2D(kernel_size=3, stride=2),
                _ConvBN(64, 80, 1), _ConvBN(80, 192, 3),
                nn.MaxPool2D(kernel_size=3, stride=2))
            self.blocks = nn.Sequential(
                _InceptionA(192, 32), _InceptionA(256, 64),
                _InceptionA(288, 64),
                _InceptionB(288),
                _InceptionC(768, 128), _InceptionC(768, 160),
                _InceptionC(768, 160), _InceptionC(768, 192),
                _InceptionD(768),
                _InceptionE(1280), _InceptionE(2048))
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            self.drop = nn.Dropout(0.5)
            if num_classes > 0:
                self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return InceptionV3(**kwargs)
