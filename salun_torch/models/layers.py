"""Shared model layers (counterpart of ``salun/models/layers.py``).

The port runs NCHW and uses ``nn.BatchNorm2d(momentum=0.1, eps=1e-5)``,
whose semantics ``salun.models.layers.TorchBatchNorm`` mirrors: normalise
with the biased batch variance, update the running variance with the
unbiased one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# CIFAR statistics baked into the reference models
# (reference Classification/models/ResNet.py:213-215).
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)


class NormalizeByChannelMeanStd(nn.Module):
    """``(x - mean) / std`` per channel, inside the model, so models take
    raw [0,1] images (ResNet.py:30-49). The constants are non-persistent
    buffers: they follow ``.to(device)`` but are not in the state dict."""

    def __init__(self, mean: Sequence[float] = CIFAR_MEAN,
                 std: Sequence[float] = CIFAR_STD):
        super().__init__()
        self.register_buffer(
            "mean", torch.tensor(mean, dtype=torch.float32).view(1, -1, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(std, dtype=torch.float32).view(1, -1, 1, 1),
            persistent=False)

    def forward(self, x):
        return (x - self.mean) / self.std


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def init_weights(module: nn.Module, generator: torch.Generator | None) -> None:
    """Seeded torchvision-style init: Kaiming-normal (fan_out) convs,
    BatchNorm weight 1 / bias 0, Linear weights U(±1/sqrt(fan_in))."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
