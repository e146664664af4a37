"""Model registry (counterpart of ``salun/models/__init__.py``).

Ported so far: ``resnet18`` (CIFAR stem) and ``resnet20s``. The other
architectures of ``salun.models.model_dict`` raise until they are ported.
"""

from __future__ import annotations

import torch

from .resnet import BasicBlock, ResNet, resnet18
from .resnets import BasicBlockA, ResNetS, resnet20s

model_dict = {
    "resnet18": resnet18,
    "resnet20s": resnet20s,
}

NOT_PORTED = ("resnet34", "resnet50", "resnet44s", "resnet56s", "vgg16_bn",
              "vgg16_bn_lth")


def create_model(arch: str, num_classes: int, imagenet: bool = False, *,
                 seed: int = 0, device="cpu") -> torch.nn.Module:
    """Build a model by registry name, with a seeded init, on ``device``."""
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet")
    if arch not in model_dict:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(model_dict)}")
    gen = torch.Generator().manual_seed(int(seed))
    if arch == "resnet18":
        model = resnet18(num_classes, imagenet=imagenet, generator=gen)
    else:
        model = model_dict[arch](num_classes, generator=gen)
    return model.to(device)


__all__ = ["BasicBlock", "BasicBlockA", "ResNet", "ResNetS", "create_model",
           "model_dict", "resnet18", "resnet20s"]
