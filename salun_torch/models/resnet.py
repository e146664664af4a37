"""ResNet-18 with the CIFAR stem (counterpart of ``salun/models/resnet.py``).

NCHW, with the reference's torch state-dict names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0/1``, ``fc``), so
``salun.ckpt.export_resnet`` output loads into it. Input normalisation is
inside the model (ResNet.py:213-215). The Bottleneck/ResNet-50 and the
ImageNet stem are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (CIFAR_MEAN, CIFAR_STD, NormalizeByChannelMeanStd,
                     batch_norm, init_weights)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=1,
                               bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                batch_norm(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet with the CIFAR stem (3x3 stride-1 conv, no maxpool,
    ResNet.py:217-223) and built-in input normalisation."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 mean=CIFAR_MEAN, std=CIFAR_STD):
        super().__init__()
        self.normalize = NormalizeByChannelMeanStd(mean, std)
        self.conv1 = nn.Conv2d(3, 64, 3, stride=1, padding=1, bias=False)
        self.bn1 = batch_norm(64)
        in_planes = 64
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BasicBlock(in_planes, planes, stride))
                in_planes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_planes, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(self.normalize(x))))
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(num_classes: int = 10, imagenet: bool = False,
             generator: torch.Generator | None = None) -> ResNet:
    """ResNet-18, CIFAR stem (Classification/models/ResNet.py resnet18)."""
    if imagenet:
        raise NotImplementedError("the ImageNet stem is not ported yet")
    model = ResNet((2, 2, 2, 2), num_classes=num_classes)
    init_weights(model, generator)
    return model
