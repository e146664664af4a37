"""RL_proximal, the mask-free SalUn variant (counterpart of
``salun/core/methods/rl_proximal.py``; reference
Classification/unlearn/RL_pro.py:8-158).

RL-style training, and after every optimizer step every parameter is
soft-thresholded toward its initial value θ_init: with d = θ − θ_init and
τ the ``ratio``-th smallest |d|,

    θ ← θ_init            where |d| ≤ τ
    θ ← θ − sign(d)·τ     otherwise.

τ is the exact k-th value (``salun_torch.dist.topk``) over the optimizer's
flat buffer, and the shrink is one pass over it. As in the JAX package
(after the reference), the CIFAR-10, CIFAR-100 and TinyImageNet runs
train on the relabelled forget set concatenated with retain
(RL_pro.py:68), and ``ratio`` is held for a whole epoch at its value for
the epoch's first step (on the SVHN branch the retain pass adds its batch
index). The steps are plain SGD: no mask, no kernel K1.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from salun_torch.core.train import train_step
from salun_torch.data.loader import to_device
from salun_torch.dist.topk import kth_largest

from .common import UnlearnConfig, make_unlearn_optimizer, snapshot_params
from .iterative import _default_source, _relabel_concat_loader


def proximal_ratio(cfg: UnlearnConfig, n_params: int, total_steps: int,
                   step_count: int) -> int:
    """How many coordinates sit at θ_init after step ``step_count``
    (RL_pro.py:53): ``max(int(mask_ratio·frac·N), 1)`` with frac = (total
    − (step + 1)) / total, in fp32 as the JAX package computes it."""
    f32 = np.float32
    frac = f32(f32(total_steps - (step_count + 1)) / f32(total_steps))
    value = f32(f32(f32(cfg.mask_ratio) * frac) * f32(n_params))
    return max(int(value), 1)


@torch.no_grad()
def proximal_shrink(flat: torch.Tensor, theta_init: torch.Tensor,
                    ratio: int) -> torch.Tensor:
    """Soft-threshold ``flat`` toward ``theta_init`` in place, τ the
    ``ratio``-th smallest |d| (the ``n − ratio + 1``-th largest); returns
    τ."""
    d = flat - theta_init
    tau = kth_largest(d.abs(), max(d.numel() - ratio + 1, 1))
    flat.copy_(torch.where(d.abs() > tau, flat - torch.sign(d) * tau,
                           theta_init))
    return tau


def RL_proximal(loaders, model, cfg: UnlearnConfig,
                mask: Optional[dict] = None, *, device,
                source: Optional[Callable] = None):
    """In place on ``model``; returns ``(model, optimizer)``. ``mask`` is
    ignored, as in the reference."""
    source = _default_source(source, cfg, device)
    steps_per_epoch = len(loaders["forget"]) + len(loaders["retain"])
    total_steps = cfg.unlearn_epochs * steps_per_epoch
    opt = make_unlearn_optimizer(cfg, model, steps_per_epoch)
    theta_init = opt.flat.flatten(snapshot_params(model))
    n_params = theta_init.numel()

    def pass_(loader, ratio_step: Callable[[int], int],
              random_labels: bool = False) -> None:
        for i, b in enumerate(loader):
            batch = to_device(b, device)
            rand = source(batch["image"].shape[0],
                          random_labels=random_labels)
            train_step(model, opt, batch, rand, random_labels=random_labels)
            proximal_shrink(opt.flat.flat, theta_init, proximal_ratio(
                cfg, n_params, total_steps, ratio_step(i)))

    for epoch in range(cfg.unlearn_epochs):
        first = epoch * steps_per_epoch
        if cfg.dataset in ("cifar10", "cifar100", "TinyImagenet"):
            pass_(_relabel_concat_loader(loaders, cfg, epoch),
                  lambda i: first)
        else:  # svhn (RL_pro.py:85-158)
            pass_(loaders["forget"], lambda i: first, random_labels=True)
            pass_(loaders["retain"], lambda i: first + i)
    return model, opt
