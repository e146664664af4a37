"""Seeding, device resolution and the TF32 setting.

Counterpart of ``salun/utils/rng.py``. JAX derives explicit PRNG keys; the
port uses explicit ``torch.Generator`` objects instead, one per stream of
randomness, created on the device that draws from them. Torch's Philox
streams cannot reproduce JAX's threefry keys, so the tests draw the random
numbers once and hand them to both sides.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present; there is no silent fall-back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "device='cpu') to run on the CPU")
    return dev


def set_tf32(enabled: bool) -> None:
    """The one place the port sets TF32 for fp32 matmuls and convolutions.

    Both flags are set explicitly: PyTorch defaults matmuls to full fp32
    but lets cuDNN run fp32 convolutions in TF32. Parity checks on the card
    call ``set_tf32(False)``.
    """
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)


def tf32_settings() -> dict:
    return {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }


def seed_all(seed: int) -> None:
    """Seed python, numpy and torch's global generators (utils.py:288-294).

    Host-side data shuffling uses numpy ``RandomState`` objects seeded
    explicitly (``salun_torch.data``); device randomness uses generators
    from :func:`make_generator`.
    """
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def make_generator(seed: int, device) -> torch.Generator:
    """A seeded generator that draws on ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
