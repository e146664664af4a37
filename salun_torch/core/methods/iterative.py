"""Iterative unlearning methods (counterpart of
``salun/core/methods/iterative.py``): ``RL`` (random labelling, the SalUn
method with a saliency mask), ``GA``/``GA_l1`` (gradient ascent on the
forget set, unlearn/GA.py), ``FT``/``FT_l1`` (fine-tuning on the retain
set, unlearn/FT.py:44-180), ``retrain`` (training from the fresh init on
the retain set, unlearn/retrain.py) and the ``raw`` baseline.

RL has two dataset regimes (reference Classification/unlearn/RL.py):
CIFAR-100/TinyImageNet relabel the forget set once per epoch and train on
forget∪retain (RL.py:51-107); CIFAR-10/SVHN draw fresh random labels per
batch on a forget pass, then do a retain pass (RL.py:109-176). With a mask
every step of RL, GA, GA_l1, FT and FT_l1 is the masked SGD step, one
launch of kernel K1 on the card; retrain ignores the mask.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Callable, Optional

import numpy as np
import torch

from salun_torch.core.train import generator_source, run_epoch
from salun_torch.data.loader import BatchIterator

from .common import UnlearnConfig, make_unlearn_optimizer, snapshot_params


def _default_source(source, cfg: UnlearnConfig, device):
    if source is not None:
        return source
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return generator_source(gen, cfg.num_classes)


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
    source = _default_source(source, cfg, device)
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


def l1_schedule(cfg: UnlearnConfig, l1_mode: str,
                steps_per_epoch: int) -> Optional[Callable[[int], float]]:
    """The α of α·Σ|θ| at an optimizer step: none; ``"const"``, α
    (GA_l1, GA.py:177); ``"decay"``, α·(1 − epoch/E) for epoch < E, else
    0, with E = max(unlearn_epochs − no_l1_epochs, 1) (FT_l1,
    FT.py:77-82). fp32, as the JAX step computes it."""
    if l1_mode == "none":
        return None
    if l1_mode == "const":
        return lambda step: cfg.alpha
    e_l1 = max(cfg.unlearn_epochs - cfg.no_l1_epochs, 1)
    f32 = np.float32

    def coeff(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if epoch >= e_l1:
            return 0.0
        return float(f32(cfg.alpha) * (f32(1.0) - f32(epoch) / f32(e_l1)))

    return coeff


def _single_loader_method(loader_name: str, loss_sign: float,
                          l1_mode: str = "none"):
    def method(loaders, model, cfg: UnlearnConfig,
               mask: Optional[dict] = None, *, device,
               source: Optional[Callable] = None):
        source = _default_source(source, cfg, device)
        loader = loaders[loader_name]
        steps_per_epoch = len(loader)
        theta0 = snapshot_params(model) if mask is not None else None
        opt = make_unlearn_optimizer(cfg, model, steps_per_epoch, mask,
                                     theta0)
        l1_coeff = l1_schedule(cfg, l1_mode, steps_per_epoch)
        for _ in range(cfg.unlearn_epochs):
            run_epoch(model, opt, loader, source, device,
                      loss_sign=loss_sign, l1_coeff=l1_coeff)
        return model, opt

    return method


GA = _single_loader_method("forget", loss_sign=-1.0)
GA_l1 = _single_loader_method("forget", loss_sign=-1.0, l1_mode="const")
FT = _single_loader_method("retain", loss_sign=1.0)
FT_l1 = _single_loader_method("retain", loss_sign=1.0, l1_mode="decay")


def retrain(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None,
            *, device, source: Optional[Callable] = None):
    """Exact unlearning: train on retain from ``model``'s current (fresh)
    weights, unmasked; the CLI skips loading θ (main_forget.py:131-132).
    Cosine warmup for ImageNet archs (impl.py:75-93)."""
    source = _default_source(source, cfg, device)
    loader = loaders["retain"]
    opt = make_unlearn_optimizer(cfg, model, len(loader), retrain=True)
    for _ in range(cfg.unlearn_epochs):
        run_epoch(model, opt, loader, source, device)
    return model, opt


def raw(loaders, model, cfg, mask=None, *, device, source=None):
    """No-op baseline (unlearn/__init__.py raw)."""
    return model, None
