"""Prune-interleaved unlearning: ``FT_prune``, ``FT_prune_bi``,
``GA_prune``, ``GA_prune_bi`` (counterpart of
``salun/core/methods/prune_variants.py``).

- ``FT_prune`` (unlearn/FT_prune.py:9-22): ``FT_l1`` (masked, K1, when a
  saliency mask is given), then the conv sparsity it reached is printed.
- ``FT_prune_bi``/``GA_prune_bi`` (unlearn/FT_prune_bi.py:9-29): FT on
  retain (GA on forget) with global L1 (or random) pruning at the start of
  every epoch with ``(E − epoch) % 2 == 0``, at the per-round rate
  ``1 − (1 − rate)^(1/((E − 1)//2 + 1))``. With E = 1 nothing is pruned.
- ``GA_prune`` (unlearn/GA_prune.py:67-209): one IMP round: GA epochs,
  prune ``1 − rate`` of the conv weights, rewind to θ_init.

The prune mask is explicit state; each step's forward reads ``p·m``
(``salun_torch.core.train.train_step``'s ``prune_mask``), and the final
weights are ``p·m``. These three train with plain SGD: no K1. Random
pruning takes its U[0, 1) scores from ``prune_scores(params)``, by default
a ``torch.Generator`` on ``device``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from salun_torch.core import pruner
from salun_torch.core.train import run_epoch

from .common import (UnlearnConfig, make_unlearn_optimizer, reset_optimizer,
                     snapshot_params)
from .iterative import FT_l1, _default_source

PRUNE_STEP = 2  # module constant of FT_prune_bi.py:6


def _bi_round_rate(cfg: UnlearnConfig, prune_step: int = PRUNE_STEP) -> float:
    """Per-round prune rate (FT_prune_bi.py:15-17)."""
    rounds = (cfg.unlearn_epochs - 1) // prune_step + 1
    return 1.0 - (1.0 - cfg.rate) ** (1.0 / rounds)


def _default_scores(prune_scores, cfg: UnlearnConfig, device) -> Callable:
    if prune_scores is not None:
        return prune_scores
    # seeded apart from the default augment draws' generator (cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    return lambda params: {
        n: torch.rand(p.shape, generator=gen, device=p.device)
        for n, p in params.items() if pruner.is_conv_kernel(p)}


def _prune(params: dict, px: float, prune_mask: dict, cfg: UnlearnConfig,
           prune_scores: Callable) -> dict:
    if cfg.random_prune:
        return pruner.global_random_prune(params, px, prune_mask,
                                          uniform=prune_scores(params))
    return pruner.global_l1_prune(params, px, prune_mask)


@torch.no_grad()
def _bake(params: dict, prune_mask: dict) -> None:
    """Weights ← p·m (torch's ``prune.remove``)."""
    for n, p in params.items():
        p.copy_(p * prune_mask[n])


def _prune_bi(loader_name: str, loss_sign: float):
    def method(loaders, model, cfg: UnlearnConfig,
               mask: Optional[dict] = None, *, device,
               source: Optional[Callable] = None,
               prune_scores: Optional[Callable] = None):
        source = _default_source(source, cfg, device)
        prune_scores = _default_scores(prune_scores, cfg, device)
        loader = loaders[loader_name]
        rate = _bi_round_rate(cfg)
        opt = make_unlearn_optimizer(cfg, model, len(loader))
        params = dict(model.named_parameters())
        prune_mask = pruner.ones_mask(params)
        for epoch in range(cfg.unlearn_epochs):
            if (cfg.unlearn_epochs - epoch) % PRUNE_STEP == 0:
                prune_mask = _prune(params, rate, prune_mask, cfg,
                                    prune_scores)
            run_epoch(model, opt, loader, source, device,
                      loss_sign=loss_sign, prune_mask=prune_mask)
        _bake(params, prune_mask)
        return model, opt

    return method


FT_prune_bi = _prune_bi("retain", loss_sign=1.0)
GA_prune_bi = _prune_bi("forget", loss_sign=-1.0)


def conv_sparsity(model) -> float:
    """% of conv-kernel weights that are exactly zero."""
    zeros = total = 0
    for p in model.parameters():
        if pruner.is_conv_kernel(p):
            zeros += int((p == 0).sum())
            total += p.numel()
    return 100.0 * zeros / max(total, 1)


def FT_prune(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None,
             *, device, source: Optional[Callable] = None):
    """``FT_l1``, then its conv sparsity (FT_prune.py:9-22)."""
    model, opt = FT_l1(loaders, model, cfg, mask, device=device,
                       source=source)
    print(f"FT_prune: natural conv sparsity after l1 FT: "
          f"{conv_sparsity(model):.2f}% zeros")
    return model, opt


def GA_prune(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None,
             *, device, source: Optional[Callable] = None,
             prune_scores: Optional[Callable] = None,
             pruning_times: int = 1, rewind: bool = True):
    """IMP with GA as the inner trainer (GA_prune.py:67-209): each round
    GA epochs from a fresh optimizer, prune ``1 − rate`` of the remaining
    conv weights, rewind to θ_init (GA_prune.py:102-110)."""
    source = _default_source(source, cfg, device)
    prune_scores = _default_scores(prune_scores, cfg, device)
    loader = loaders["forget"]
    opt = make_unlearn_optimizer(cfg, model, len(loader))
    params = dict(model.named_parameters())
    prune_mask = pruner.ones_mask(params)
    init = opt.flat.flatten(snapshot_params(model))
    for _ in range(pruning_times):
        reset_optimizer(opt)
        for _ in range(cfg.unlearn_epochs):
            run_epoch(model, opt, loader, source, device, loss_sign=-1.0,
                      prune_mask=prune_mask)
        prune_mask = _prune(params, 1.0 - cfg.rate, prune_mask, cfg,
                            prune_scores)
        if rewind:
            opt.flat.flat.copy_(init)
    _bake(params, prune_mask)
    return model, opt
