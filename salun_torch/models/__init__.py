"""Model registry (counterpart of ``salun/models/__init__.py``): the names
of ``salun.models.model_dict``. resnet32s and resnet110s are exported but,
as there, not registered."""

from __future__ import annotations

import torch

from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50)
from .resnets import (BasicBlockA, ResNetS, resnet20s, resnet32s, resnet44s,
                      resnet56s, resnet110s)
from .vgg import VGG, vgg16_bn, vgg16_bn_lth

model_dict = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet20s": resnet20s,
    "resnet44s": resnet44s,
    "resnet56s": resnet56s,
    "vgg16_bn": vgg16_bn,
    "vgg16_bn_lth": vgg16_bn_lth,
}


def create_model(arch: str, num_classes: int, imagenet: bool = False, *,
                 seed: int = 0, device="cpu", **norm) -> torch.nn.Module:
    """Build a model by registry name, with a seeded init, on ``device``.
    ``imagenet`` picks the stem of resnet18 and resnet50, as in
    ``salun.models.create_model``; resnet34 always has the ImageNet one.
    ``norm`` (``mean``, ``std``) sets resnet50's input normalisation;
    the other architectures take none and raise."""
    if arch not in model_dict:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(model_dict)}")
    gen = torch.Generator().manual_seed(int(seed))
    if arch in ("resnet18", "resnet50"):
        model = model_dict[arch](num_classes, imagenet=imagenet, generator=gen,
                                 **norm)
    else:
        model = model_dict[arch](num_classes, generator=gen, **norm)
    return model.to(device)


__all__ = ["BasicBlock", "BasicBlockA", "Bottleneck", "ResNet", "ResNetS",
           "VGG", "create_model", "model_dict", "resnet18", "resnet20s",
           "resnet32s", "resnet34", "resnet44s", "resnet50", "resnet56s",
           "resnet110s", "vgg16_bn", "vgg16_bn_lth"]
