"""Exponential moving average of parameters (counterpart of
``salun/diffusion/ema.py``; reference DDPM/models/ema.py:5-51)."""

from __future__ import annotations

import torch


def ema_init(model: torch.nn.Module) -> dict:
    """A copy of the parameters, ``{name: tensor}``."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(model: torch.nn.Module, shadow: dict, mu: float = 0.999):
    """shadow ← (1−μ)·θ + μ·shadow, in place (ema.py:17-24)."""
    for n, p in model.named_parameters():
        shadow[n].copy_((1.0 - mu) * p + mu * shadow[n])
