"""VGG-16 with BatchNorm (counterpart of ``salun/models/vgg.py``).

Two variants, each with CIFAR input normalisation inside the model
(VGG.py:69-72):
- ``vgg16_bn`` (Classification/models/VGG.py:56-256): bias-free convs, an
  adaptive 2x2 average pool (which replicates CIFAR's 1x1 map to 2x2), and
  a 2048 → 256 → 256 → classes head;
- ``vgg16_bn_lth`` (VGG_LTH.py:50-64): convs with bias, a global average
  pool and one Linear.

Names are the reference torch layout: ``features.N`` for the N-th entry of
the conv/BN/ReLU/max-pool sequence, ``classifier.{0,2,4}`` for the head's
Linears (``classifier`` alone for the LTH head), so
``salun.ckpt.import_vgg`` reads the port's checkpoints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (CIFAR_MEAN, CIFAR_STD, NormalizeByChannelMeanStd,
                     batch_norm, init_weights)

# Configuration "D" (VGG-16) without torchvision's final "M", the
# reference's CIFAR adaptation (VGG.py:97-145): a 2x2 map at 32px input.
CFG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512)


def conv_feature_indices() -> list:
    """``features`` index of the i-th conv (its BatchNorm is the next)."""
    out, idx = [], 0
    for v in CFG_D:
        if v == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 3  # conv, BN, ReLU
    return out


class VGG(nn.Module):
    def __init__(self, num_classes: int = 10, lth_head: bool = False,
                 mean=CIFAR_MEAN, std=CIFAR_STD):
        super().__init__()
        self.normalize = NormalizeByChannelMeanStd(mean, std)
        layers, in_ch = [], 3
        for v in CFG_D:
            if v == "M":
                layers.append(nn.MaxPool2d(2, stride=2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1, bias=lth_head),
                           batch_norm(v), nn.ReLU(inplace=True)]
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.lth_head = lth_head
        if lth_head:
            self.classifier = nn.Linear(512, num_classes)
        else:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 2 * 2, 256), nn.ReLU(inplace=True),
                nn.Linear(256, 256), nn.ReLU(inplace=True),
                nn.Linear(256, num_classes))

    def forward(self, x):
        x = self.features(self.normalize(x))
        if self.lth_head:
            return self.classifier(x.mean(dim=(2, 3)))
        x = F.adaptive_avg_pool2d(x, (2, 2))
        return self.classifier(torch.flatten(x, 1))


def vgg16_bn(num_classes: int = 10,
             generator: torch.Generator | None = None) -> VGG:
    model = VGG(num_classes, lth_head=False)
    init_weights(model, generator)
    return model


def vgg16_bn_lth(num_classes: int = 10,
                 generator: torch.Generator | None = None) -> VGG:
    model = VGG(num_classes, lth_head=True)
    init_weights(model, generator)
    return model
