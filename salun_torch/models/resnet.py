"""ResNet-18/34/50 (counterpart of ``salun/models/resnet.py``).

NCHW, with the reference's torch state-dict names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.conv3``/``bn3`` in a Bottleneck,
``layer1.0.downsample.0/1``, ``fc``), so ``salun.ckpt.export_resnet``
output loads into it. Input normalisation is inside the model
(ResNet.py:213-215). Two stems: CIFAR (3x3 stride-1 conv, no max-pool,
ResNet.py:217-223) and ImageNet (7x7 stride-2 conv, BN, ReLU, 3x3 stride-2
max-pool with padding 1, ResNet.py:224-230).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (CIFAR_MEAN, CIFAR_STD, NormalizeByChannelMeanStd,
                     batch_norm, init_weights)

# torch ImageNet normalisation (resnet34's default)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _downsample(in_planes: int, out_planes: int, stride: int):
    """1x1 conv + BN on the shortcut where the shape changes."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False),
        batch_norm(out_planes))


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
        self.downsample = _downsample(in_planes, planes, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (the stride) → 1x1 to 4× the width
    (``salun/models/resnet.py:64-94``)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = _downsample(in_planes, out, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet with the CIFAR or the ImageNet stem and built-in input
    normalisation."""

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock,
                 num_classes: int = 10, imagenet_stem: bool = False,
                 mean=CIFAR_MEAN, std=CIFAR_STD):
        super().__init__()
        self.normalize = NormalizeByChannelMeanStd(mean, std)
        if imagenet_stem:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, 64, 3, stride=1, padding=1, bias=False)
        self.bn1 = batch_norm(64)
        self.imagenet_stem = imagenet_stem
        in_planes = 64
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(in_planes, planes, stride))
                in_planes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_planes, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(self.normalize(x))))
        if self.imagenet_stem:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def _build(stage_sizes, block, num_classes, imagenet, generator, **kw):
    model = ResNet(stage_sizes, block, num_classes=num_classes,
                   imagenet_stem=imagenet, **kw)
    init_weights(model, generator)
    return model


def resnet18(num_classes: int = 10, imagenet: bool = False,
             generator: torch.Generator | None = None) -> ResNet:
    """ResNet-18 (Classification/models/ResNet.py resnet18); ``imagenet``
    picks the stem."""
    return _build((2, 2, 2, 2), BasicBlock, num_classes, imagenet, generator)


def resnet34(num_classes: int = 10, imagenet: bool = True,
             generator: torch.Generator | None = None) -> ResNet:
    """ResNet-34 with the ImageNet stem and ImageNet mean/std by default
    (the DDPM classifier evaluation's, ``salun/models/resnet.py:151-156``)."""
    return _build((3, 4, 6, 3), BasicBlock, num_classes, imagenet, generator,
                  mean=IMAGENET_MEAN, std=IMAGENET_STD)


def resnet50(num_classes: int = 10, imagenet: bool = False,
             generator: torch.Generator | None = None, mean=CIFAR_MEAN,
             std=CIFAR_STD) -> ResNet:
    """ResNet-50; ``mean``/``std`` are the built-in normalisation's (the
    ImageNet ones for ``sd_eval imageclassify``)."""
    return _build((3, 4, 6, 3), Bottleneck, num_classes, imagenet, generator,
                  mean=mean, std=std)
