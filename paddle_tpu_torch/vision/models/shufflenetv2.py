"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``:
x0_25 … x2_0 and the swish variant).

The channel shuffle is a reshape, a transpose and a reshape, as in the
reference.
"""

from __future__ import annotations

from ... import nn
from ...tensor.manipulation import concat, reshape, transpose
from ._utils import refuse_pretrained


def _channel_shuffle(x, groups):
    B, C, H, W = x.shape
    x = reshape(x, [B, groups, C // groups, H, W])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [B, C, H, W])


def _act(name):
    return nn.Swish() if name == "swish" else nn.ReLU()


class _InvertedResidual(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                nn.Conv2D(in_ch // 2, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), _act(act),
                nn.Conv2D(branch, branch, 3, stride=1, padding=1,
                          groups=branch, bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), _act(act))
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), _act(act))
            self.branch2 = nn.Sequential(
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), _act(act),
                nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                          groups=branch, bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), _act(act))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_STAGE_OUT = {
    "0.25": (24, 24, 48, 96, 512), "0.33": (24, 32, 64, 128, 512),
    "0.5": (24, 48, 96, 192, 1024), "1.0": (24, 116, 232, 464, 1024),
    "1.5": (24, 176, 352, 704, 1024), "2.0": (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


class ShuffleNetV2(nn.Layer):
    """``device`` defaults to the enclosing ``nn.building`` scope's, else
    ``cuda`` (raises without a card); the weights are drawn from
    ``core.rng``'s stream on it, as the reference's are."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None):
        super().__init__()
        key = scale if isinstance(scale, str) else format(float(scale), "g")
        key = {"1": "1.0", "2": "2.0"}.get(key, key)
        if key not in _STAGE_OUT:
            raise ValueError(f"unsupported scale {scale!r}; "
                             f"choose from {sorted(_STAGE_OUT)}")
        chs = _STAGE_OUT[key]
        with nn.building(device):
            self.conv1 = nn.Sequential(
                nn.Conv2D(3, chs[0], 3, stride=2, padding=1,
                          bias_attr=False),
                nn.BatchNorm2D(chs[0]), _act(act))
            self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
            stages = []
            in_ch = chs[0]
            for out_ch, n in zip(chs[1:4], _REPEATS):
                stages.append(_InvertedResidual(in_ch, out_ch, 2, act))
                for _ in range(n - 1):
                    stages.append(_InvertedResidual(out_ch, out_ch, 1, act))
                in_ch = out_ch
            self.stages = nn.Sequential(*stages)
            self.conv_last = nn.Sequential(
                nn.Conv2D(in_ch, chs[4], 1, bias_attr=False),
                nn.BatchNorm2D(chs[4]), _act(act))
            self.with_pool = with_pool
            self.num_classes = num_classes
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(chs[4], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(scale, act, pretrained, **kwargs):
    refuse_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet("0.25", "relu", pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet("0.33", "relu", pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet("0.5", "relu", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet("1.0", "relu", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet("1.5", "relu", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet("2.0", "relu", pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet("1.0", "swish", pretrained, **kwargs)
