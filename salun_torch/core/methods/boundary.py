"""Decision-boundary unlearning, ``boundary_shrink`` and
``boundary_expanding`` (counterpart of ``salun/core/methods/boundary.py``;
reference Classification/unlearn/boundary_sh.py:35-141,
boundary_ex.py:34-138).

- *shrink*: FGSM on the forget inputs (bound 0.1, against the true label,
  then rounded to the 255-grid) through a frozen copy of the model in eval
  mode; the frozen model's prediction on the adversarial input becomes the
  label the live model trains toward. The forget image is augmented once
  with the draws of ``source`` and the same image feeds the FGSM and the
  step, whose own augmentation is off (boundary_sh.py:69-82).
- *expanding*: the model is rebuilt with ``num_classes + 1`` outputs, the
  old parameters copied in and the new output row fresh; every forget
  sample trains toward that shadow class. The new model is returned.

With a saliency mask both are masked SGD: one launch of kernel K1 a step
on the card. For *expanding* the mask is grafted onto the wide shapes
with the new coordinates trainable (1), and θ₀ is the wide parameters.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from salun_torch.core.train import cross_entropy, train_step
from salun_torch.data.loader import augment, to_device, to_float
from salun_torch.models import create_model

from .common import UnlearnConfig, make_unlearn_optimizer, snapshot_params
from .iterative import _default_source

FGSM_BOUND = 0.1  # "hard coding in the paper" (boundary_sh.py:66)


def adversarial_labels(frozen, img: torch.Tensor,
                       label: torch.Tensor) -> torch.Tensor:
    """FGSM on ``frozen`` (eval mode) against ``label``, discretised, then
    ``frozen``'s argmax on the adversarial image (boundary_sh.py:39-52,
    90-96)."""
    x = img.detach().requires_grad_(True)
    g, = torch.autograd.grad(cross_entropy(frozen(x), label), x)
    with torch.no_grad():
        x_adv = torch.round(
            torch.clamp(img + torch.sign(g) * FGSM_BOUND, 0.0, 1.0) * 255.0
        ) / 255.0
        return frozen(x_adv).argmax(dim=-1)


def boundary_shrink(loaders, model, cfg: UnlearnConfig,
                    mask: Optional[dict] = None, *, device,
                    source: Optional[Callable] = None):
    """In place on ``model``; returns ``(model, optimizer)``."""
    source = _default_source(source, cfg, device)
    loader = loaders["forget"]
    theta0 = snapshot_params(model) if mask is not None else None
    opt = make_unlearn_optimizer(cfg, model, len(loader), mask, theta0)
    frozen = copy.deepcopy(model).eval().requires_grad_(False)
    for _ in range(cfg.unlearn_epochs):
        for b in loader:
            batch = to_device(b, device)
            rand = source(batch["image"].shape[0])
            img = to_float(batch["image"])
            if not cfg.imagenet_arch:
                img = augment(img, rand["offsets"], rand["flips"])
            batch = dict(batch, image=img,
                         label=adversarial_labels(frozen, img,
                                                  batch["label"]))
            train_step(model, opt, batch, rand, use_augment=False)
    return model, opt


def _graft(wide: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``wide`` with its leading ``old.shape`` block replaced by ``old``."""
    if wide.shape == old.shape:
        return old.clone()
    out = wide.clone()
    out[tuple(slice(0, s) for s in old.shape)] = old
    return out


def expand_head(model, cfg: UnlearnConfig, device,
                wide_init: Optional[dict] = None):
    """The model with one more output (boundary_ex.py:36-67): every
    parameter and BatchNorm statistic copied, the output layer's old rows
    copied and its new row from ``wide_init`` (a state dict of the wide
    model; by default its seeded init, ``create_model(seed=cfg.seed)``)."""
    wide = create_model(cfg.arch, cfg.num_classes + 1,
                        imagenet=cfg.imagenet_arch, seed=cfg.seed,
                        device=device)
    init = wide.state_dict() if wide_init is None else wide_init
    old = model.state_dict()
    wide.load_state_dict({n: _graft(init[n].to(device), old[n])
                          for n in wide.state_dict()})
    return wide


def boundary_expanding(loaders, model, cfg: UnlearnConfig,
                       mask: Optional[dict] = None, *, device,
                       source: Optional[Callable] = None,
                       wide_init: Optional[dict] = None):
    """Trains a widened copy of ``model``; returns ``(wide model,
    optimizer)``."""
    source = _default_source(source, cfg, device)
    wide = expand_head(model, cfg, device, wide_init)
    wide_mask = theta0 = None
    if mask is not None:
        wide_mask = {n: _graft(torch.ones_like(p), mask[n].to(p))
                     if n in mask else torch.ones_like(p)
                     for n, p in wide.named_parameters()}
        theta0 = snapshot_params(wide)
    loader = loaders["forget"]
    opt = make_unlearn_optimizer(cfg, wide, len(loader), wide_mask, theta0)
    shadow = cfg.num_classes  # boundary_ex.py:95-98
    for _ in range(cfg.unlearn_epochs):
        for b in loader:
            batch = to_device(b, device)
            batch["label"] = torch.full_like(batch["label"], shadow)
            rand = source(batch["image"].shape[0])
            train_step(wide, opt, batch, rand,
                       use_augment=not cfg.imagenet_arch)
    return wide, opt
