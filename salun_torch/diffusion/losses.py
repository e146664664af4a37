"""Diffusion training loss (counterpart of ``salun/diffusion/losses.py``;
reference DDPM/functions/losses.py:4-46): the eps-prediction MSE summed
over the pixel dimensions and meaned over the batch."""

from __future__ import annotations


def eps_mse(e, out):
    """``(e − out)²`` summed over every dimension but the batch, meaned
    over the batch."""
    return (e - out).square().sum(dim=tuple(range(1, e.dim()))).mean()
