"""Shared scaffolding for unlearning methods (counterpart of
``salun/core/methods/common.py``; reference ``@iterative_unlearn``,
Classification/unlearn/impl.py:54-127).

Methods are plain functions ``(loaders, model, cfg, mask, source, device)
→ (model, optimizer)`` that update ``model`` in place: SGD(momentum, wd)
with per-epoch MultiStepLR (γ=0.1), or per-epoch cosine warmup for
ImageNet retraining, over flat parameter buffers; masked (kernel K1) when
a saliency mask and θ₀ are given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from salun_torch.core.masked_opt import FlatParams, build_optimizer
from salun_torch.core.train import cosine_warmup_lr, multistep_lr


@dataclass
class UnlearnConfig:
    """Typed equivalent of the reference's argparse namespace
    (Classification/arg_parser.py:4-145, unlearn group)."""

    dataset: str = "cifar10"
    num_classes: int = 10
    arch: str = "resnet18"
    imagenet_arch: bool = False

    unlearn_lr: float = 0.01
    unlearn_epochs: int = 10
    momentum: float = 0.9
    weight_decay: float = 5e-4
    decreasing_lr: str = "91,136"
    warmup: int = 0
    batch_size: int = 256

    alpha: float = 0.2
    no_l1_epochs: int = 0
    mask_ratio: float = 0.5
    class_to_replace: int = -1
    num_indexes_to_replace: Optional[int] = None

    rate: float = 0.95
    prune_step: int = 1
    random_prune: bool = False

    seed: int = 2
    print_freq: int = 50


def snapshot_params(model: torch.nn.Module) -> list:
    """θ₀: a copy of every parameter, in ``named_parameters`` order."""
    return [p.detach().clone() for p in model.parameters()]


def mask_tensors(model: torch.nn.Module, mask: dict) -> list:
    """``{torch_name: 0/1 tensor}`` → one tensor per parameter in
    ``named_parameters`` order; parameters the mask omits get all ones
    (as ``salun.ckpt.import_mask`` does)."""
    unknown = set(mask) - {n for n, _ in model.named_parameters()}
    if unknown:
        raise KeyError(f"mask names no parameter of the model: "
                       f"{sorted(unknown)[:5]}")
    return [mask[n] if n in mask else torch.ones_like(p)
            for n, p in model.named_parameters()]


def make_unlearn_optimizer(cfg: UnlearnConfig, model: torch.nn.Module,
                           steps_per_epoch: int, mask: Optional[dict] = None,
                           theta0: Optional[list] = None,
                           retrain: bool = False):
    """Optimizer + schedule per impl.py:68-97, over flat buffers
    (``salun/core/methods/common.py:57-80``).

    The schedule is cosine warmup for ``cfg.imagenet_arch and retrain``,
    else MultiStepLR. ``mask`` and ``theta0`` → :class:`MaskedSGD` (K1);
    ``mask`` alone → :class:`GradMaskSGD` (grads masked, nothing pinned);
    no mask → plain :class:`SGD`.
    """
    if cfg.imagenet_arch and retrain:
        sched = cosine_warmup_lr(cfg.unlearn_lr, cfg.warmup,
                                 cfg.unlearn_epochs, steps_per_epoch)
    else:
        milestones = [int(x) for x in str(cfg.decreasing_lr).split(",") if x]
        sched = multistep_lr(cfg.unlearn_lr, milestones, steps_per_epoch)
    flat = FlatParams(model.parameters())
    return build_optimizer(
        flat, sched, cfg.momentum, cfg.weight_decay,
        mask=None if mask is None else flat.flatten(mask_tensors(model,
                                                                 mask)),
        theta0=None if theta0 is None or mask is None
        else flat.flatten(theta0))


def reset_optimizer(opt) -> None:
    """A fresh optimizer state for a new phase (``reset_opt_state``,
    ``salun/core/methods/common.py:83``): momentum zero and the step count,
    which drives the schedule, back to 0. The parameters stay as they
    are."""
    opt.trace.zero_()
    opt.count = 0
