"""GoogLeNet / Inception v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``)."""

from __future__ import annotations

from ... import nn
from ...tensor.manipulation import concat
from ._utils import ConvBNReLU as _ConvBN
from ._utils import refuse_pretrained


class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_ch, c1, 1)
        self.b2 = nn.Sequential(_ConvBN(in_ch, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_ConvBN(in_ch, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(kernel_size=3, stride=1,
                                             padding=1),
                                _ConvBN(in_ch, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class GoogLeNet(nn.Layer):
    """Returns ``(main, aux1, aux2)`` logits in train mode, as the
    reference does; a train step's loss reads the first.  ``device``
    defaults to the enclosing ``nn.building`` scope's, else ``cuda``
    (raises without a card).  The three dropouts (each aux head's, then
    the main one, in that order) draw from ``core.rng``."""

    def __init__(self, num_classes=1000, with_pool=True, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with nn.building(device):
            self.stem = nn.Sequential(
                _ConvBN(3, 64, 7, stride=2, padding=3),
                nn.MaxPool2D(kernel_size=3, stride=2, padding=1),
                _ConvBN(64, 64, 1), _ConvBN(64, 192, 3, padding=1),
                nn.MaxPool2D(kernel_size=3, stride=2, padding=1))
            self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
            self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
            self.pool3 = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
            self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
            self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
            self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
            self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
            self.pool4 = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
            self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
            if with_pool:
                self.pool5 = nn.AdaptiveAvgPool2D(1)
            self.drop = nn.Dropout(0.4)
            if num_classes > 0:
                self.fc = nn.Linear(1024, num_classes)
                self.aux1 = nn.Sequential(
                    nn.AdaptiveAvgPool2D(4), nn.Flatten(),
                    nn.Linear(512 * 16, 1024), nn.ReLU(), nn.Dropout(0.7),
                    nn.Linear(1024, num_classes))
                self.aux2 = nn.Sequential(
                    nn.AdaptiveAvgPool2D(4), nn.Flatten(),
                    nn.Linear(528 * 16, 1024), nn.ReLU(), nn.Dropout(0.7),
                    nn.Linear(1024, num_classes))

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        aux = self.num_classes > 0 and self.training
        a1 = self.aux1(x) if aux else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if aux else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
            if self.training:
                return x, a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return GoogLeNet(**kwargs)
