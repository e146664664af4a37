"""Iterative unlearning methods (counterpart of
``salun/core/methods/iterative.py``): ``RL`` (random labelling, the SalUn
method with a saliency mask) and the ``raw`` baseline. GA, FT, their l1
variants and retrain wait for a later slice.

RL has two dataset regimes (reference Classification/unlearn/RL.py):
CIFAR-100/TinyImageNet relabel the forget set once per epoch and train on
forget∪retain (RL.py:51-107); CIFAR-10/SVHN draw fresh random labels per
batch on a forget pass, then do a retain pass (RL.py:109-176). With a mask
every step is the masked SGD step, one launch of kernel K1 on the card.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Callable, Optional

import numpy as np
import torch

from salun_torch.core.train import generator_source, run_epoch
from salun_torch.data.loader import BatchIterator

from .common import UnlearnConfig, make_unlearn_optimizer, snapshot_params


def _relabel_concat_loader(loaders, cfg: UnlearnConfig, epoch: int):
    """Forget set with fresh random labels from a Generator seeded by
    (cfg.seed, epoch), concatenated with retain and shuffled (RL.py:51-59);
    the same numpy draws as the JAX package."""
    gen = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch]))
    forget = loaders["forget"].ds.copy()
    forget.targets = gen.integers(
        0, cfg.num_classes, forget.targets.shape, dtype=forget.targets.dtype)
    retain = loaders["retain"].ds
    merged = dc_replace(forget,
                        data=np.concatenate([forget.data, retain.data]),
                        targets=np.concatenate([forget.targets,
                                                retain.targets]))
    return BatchIterator(merged, cfg.batch_size, shuffle=True,
                         seed=cfg.seed + epoch)


def RL(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None, *,
       device, source: Optional[Callable] = None):
    """Random-label unlearning, in place on ``model``; returns
    ``(model, optimizer)``. ``source`` gives each step's randomness
    (``salun_torch.core.train``); by default a generator seeded with
    ``cfg.seed`` on ``device``."""
    if source is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        source = generator_source(gen, cfg.num_classes)
    steps_per_epoch = len(loaders["forget"]) + len(loaders["retain"])
    theta0 = snapshot_params(model) if mask is not None else None
    opt = make_unlearn_optimizer(cfg, model, steps_per_epoch, mask, theta0)

    if cfg.dataset in ("cifar100", "TinyImagenet"):
        for epoch in range(cfg.unlearn_epochs):
            loader = _relabel_concat_loader(loaders, cfg, epoch)
            run_epoch(model, opt, loader, source, device)
    else:  # cifar10 / svhn path (RL.py:109-176)
        for _ in range(cfg.unlearn_epochs):
            run_epoch(model, opt, loaders["forget"], source, device,
                      random_labels=True)
            run_epoch(model, opt, loaders["retain"], source, device)
    return model, opt


def raw(loaders, model, cfg, mask=None, *, device, source=None):
    """No-op baseline (unlearn/__init__.py raw)."""
    return model, None
