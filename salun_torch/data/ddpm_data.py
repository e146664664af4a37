"""DDPM workload data (counterpart of ``salun/data/ddpm_data.py``;
reference DDPM/datasets/__init__.py:30-298): the dataset by name, the
retain/forget class split, the endless batch stream and the per-sample
horizontal flip of the train-side loaders.

Ported readers: CIFAR-10 and the synthetic stand-in. STL-10 raises until
it is ported: it trains at 64×64, which needs the PIL bilinear resize.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .datasets import ArrayDataset, cifar10, synthetic
from .loader import BatchIterator


def get_dataset(name: str, data_dir: str, train: bool = True,
                image_size: Optional[int] = None) -> ArrayDataset:
    """Dataset by name, at its native size; a different ``image_size``
    raises (the resize is not ported)."""
    if name.lower() == "cifar10":
        ds = cifar10(data_dir, train)
    elif name.lower() == "stl10":
        raise NotImplementedError(
            "STL-10 is not ported yet: it trains at 64x64, which needs the "
            "PIL bilinear resize (ROADMAP queue 1, slice C)")
    elif name == "synthetic":
        ds = synthetic(n=512 if train else 128)
    else:
        raise KeyError(name)
    if image_size and ds.data.shape[1] != image_size:
        raise NotImplementedError(
            f"{name} is {ds.data.shape[1]}x{ds.data.shape[1]}; resizing to "
            f"{image_size} is not ported")
    return ds


def get_forget_dataset(ds: ArrayDataset, label_to_forget: int
                       ) -> Tuple[ArrayDataset, ArrayDataset]:
    """(remain, forget) class split (datasets/__init__.py:120-177)."""
    forget_idx = np.flatnonzero(ds.targets == label_to_forget)
    remain_idx = np.flatnonzero(ds.targets != label_to_forget)
    return ds.select(remain_idx), ds.select(forget_idx)


def cycle(loader: BatchIterator):
    """Endless batch stream (functions/__init__.py cycle)."""
    while True:
        for batch in loader:
            yield batch


def random_hflip(x: torch.Tensor, flips: Optional[torch.Tensor] = None, *,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample horizontal flip with p = 0.5 of NCHW images
    (``transforms.RandomHorizontalFlip``, DDPM/datasets/__init__.py:34-46).
    ``flips`` ([B] bool) injects the draws; otherwise they come from
    ``generator``."""
    if flips is None:
        flips = torch.rand(x.shape[0], generator=generator,
                           device=x.device) < 0.5
    flips = flips.to(x.device, torch.bool)
    return torch.where(flips[:, None, None, None], x.flip(-1), x)
