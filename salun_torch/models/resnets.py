"""Small CIFAR ResNet-s (counterpart of ``salun/models/resnets.py``).

akamaster-style (Classification/models/ResNets.py:82-191): 16→32→64
channels, option-A shortcut = stride-2 subsample + zero-padded channels
(ResNets.py:98-109); resnet20s/32s/44s/56s/110s have 3/5/7/9/18 blocks a
stage. Names follow the JAX model through ``salun.ckpt.export_resnet``
(``layer1.0.conv1``, ``fc``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (CIFAR_MEAN, CIFAR_STD, NormalizeByChannelMeanStd,
                     batch_norm, init_weights)


class BasicBlockA(nn.Module):
    """3x3-3x3 block with the parameter-free option-A shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=1,
                               bias=False)
        self.bn2 = batch_norm(planes)
        self.stride = stride
        self.pad = planes // 4 if (stride != 1 or in_planes != planes) else 0

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x
        if self.pad:
            shortcut = F.pad(x[:, :, ::self.stride, ::self.stride],
                             (0, 0, 0, 0, self.pad, self.pad))
        return F.relu(y + shortcut)


class ResNetS(nn.Module):
    """conv3x3(16) stem, 3 stages of ``n_blocks`` blocks each."""

    def __init__(self, n_blocks: int, num_classes: int = 10,
                 mean: Sequence[float] = CIFAR_MEAN,
                 std: Sequence[float] = CIFAR_STD):
        super().__init__()
        self.normalize = NormalizeByChannelMeanStd(mean, std)
        self.conv1 = nn.Conv2d(3, 16, 3, stride=1, padding=1, bias=False)
        self.bn1 = batch_norm(16)
        in_planes = 16
        for i, planes in enumerate((16, 32, 64)):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BasicBlockA(in_planes, planes, stride))
                in_planes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(64, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(self.normalize(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(x.mean(dim=(2, 3)))


def _resnet_s(n_blocks: int):
    def build(num_classes: int = 10,
              generator: torch.Generator | None = None) -> ResNetS:
        model = ResNetS(n_blocks, num_classes=num_classes)
        init_weights(model, generator)
        return model

    build.__name__ = f"resnet{6 * n_blocks + 2}s"
    return build


resnet20s = _resnet_s(3)
resnet32s = _resnet_s(5)
resnet44s = _resnet_s(7)
resnet56s = _resnet_s(9)
resnet110s = _resnet_s(18)
