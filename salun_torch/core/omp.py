"""One-shot magnitude pruning with rewind training (counterpart of
``salun/core/omp.py``; reference Classification/pruner/omp.py and the
``train_with_rewind`` that trainer/__init__.py:1 declares but never
defines).

``train_with_rewind`` trains while it snapshots the weights at
``rewind_epoch`` (lottery-ticket rewinding); ``omp_prune`` trains, prunes
globally by L1, random or iterative SynFlow scores, and rewinds to the
snapshot with a fresh optimizer state. No CLI reaches them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from salun_torch.core import pruner
from salun_torch.core.methods.common import reset_optimizer
from salun_torch.core.train import run_epoch


def train_with_rewind(model, opt, loader, epochs: int, rewind_epoch: int,
                      source: Callable, device, *,
                      prune_mask: Optional[dict] = None) -> torch.Tensor:
    """Train ``model`` in place (``opt`` one of the port's flat-buffer
    optimizers over it); returns the flat weights at the start of epoch
    ``rewind_epoch`` (or at the end, if training ends first)."""
    rewind = None
    for epoch in range(epochs):
        if epoch == rewind_epoch:
            rewind = opt.flat.flat.clone()
        run_epoch(model, opt, loader, source, device, prune_mask=prune_mask)
    return opt.flat.flat.clone() if rewind is None else rewind


def omp_prune(model, opt, loader, *, rate: float, epochs: int,
              rewind_epoch: int, source: Callable, device,
              score: str = "l1", uniform: Optional[dict] = None,
              input_shape=(1, 3, 32, 32),
              synflow_iterations: int = 100) -> dict:
    """Train, prune ``rate`` of the conv weights by ``score`` (``"l1"``,
    ``"random"`` with U[0, 1) scores ``uniform``, or ``"synflow"``),
    then rewind ``model`` to the snapshot and reset ``opt``; returns the
    prune mask."""
    rewind = train_with_rewind(model, opt, loader, epochs, rewind_epoch,
                               source, device)
    params = dict(model.named_parameters())
    if score == "l1":
        mask = pruner.global_l1_prune(params, rate)
    elif score == "random":
        mask = pruner.global_random_prune(params, rate, uniform=uniform)
    elif score == "synflow":
        mask = pruner.synflow_prune(model, params, rate, input_shape,
                                    iterations=synflow_iterations)
    else:
        raise ValueError(score)
    opt.flat.flat.copy_(rewind)
    reset_optimizer(opt)
    return mask
