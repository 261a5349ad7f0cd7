"""MobileNet V1 and V2 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``)."""

from __future__ import annotations

from ... import nn
from ._utils import refuse_pretrained


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if act == "relu6" else (
            nn.ReLU() if act else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c)
        self.pw = ConvBNLayer(c1, c2, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        cfg = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
               (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
               *[(512, 512, 512, 1)] * 5, (512, 512, 1024, 2),
               (1024, 1024, 1024, 1)]
        with nn.building(device):
            self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1)
            self.blocks = nn.Sequential(*[
                DepthwiseSeparable(s(in_c), c1, c2, stride, scale)
                for in_c, c1, c2, stride in cfg])
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6"))
        layers += [ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden,
                               act="relu6"),
                   ConvBNLayer(hidden, oup, 1, act=None)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are.  The classifier's dropout draws from
    ``core.rng``."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = int(32 * scale)
        with nn.building(device):
            self.conv1 = ConvBNLayer(3, input_channel, 3, 2, 1, act="relu6")
            blocks = []
            for t, c, n, s in cfg:
                out_c = int(c * scale)
                for i in range(n):
                    blocks.append(InvertedResidual(input_channel, out_c,
                                                   s if i == 0 else 1, t))
                    input_channel = out_c
            self.blocks = nn.Sequential(*blocks)
            self.last_channel = int(1280 * max(1.0, scale))
            self.conv_last = ConvBNLayer(input_channel, self.last_channel, 1,
                                         act="relu6")
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.2), nn.Linear(self.last_channel,
                                               num_classes))

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    """The reference ignores ``pretrained``; the port refuses it, as the
    reference's other families do."""
    refuse_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    """As :func:`mobilenet_v1` for ``pretrained``."""
    refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
