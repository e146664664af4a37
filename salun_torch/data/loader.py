"""Batch iteration and augmentation (counterpart of ``salun/data/loader.py``).

The host shuffles indices and slices uint8 arrays exactly as the JAX
``BatchIterator`` does (same permutation, same weight-0 cyclic padding of
the final batch, so batch shapes never change). :func:`to_device` moves a
batch to the device and to NCHW; float conversion and augmentation run
there. :func:`augment` takes its crop offsets and flips as arguments;
:func:`draw_augment` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from .datasets import ArrayDataset


class BatchIterator:
    """Numpy-side epoch iterator with static batch shapes.

    Yields dict batches: ``image`` uint8 NHWC, ``label`` int32, ``weight``
    float32 (0 for the padding rows of the final batch).
    """

    def __init__(self, ds: ArrayDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 1):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (len(self.ds) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + self._epoch) % (2**31 - 1))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        self._epoch += 1  # consecutive passes see different orders
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            img = self.ds.data[idx]
            lab = self.ds.targets[idx].astype(np.int32)
            w = np.ones(len(idx), np.float32)
            if len(idx) < bs:
                # Padding repeats real samples cyclically with weight 0:
                # BatchNorm sees them, the loss and the metrics do not.
                pad = bs - len(idx)
                rep = np.resize(np.arange(len(idx)), pad)
                img = np.concatenate([img, img[rep]])
                lab = np.concatenate([lab, lab[rep]])
                w = np.concatenate([w, np.zeros(pad, np.float32)])
            yield {"image": img, "label": lab, "weight": w}


def to_device(batch: dict, device) -> dict:
    """Host batch → tensors on ``device``: image uint8 NCHW, label int64,
    weight float32."""
    img = torch.from_numpy(np.ascontiguousarray(batch["image"]))
    return {
        "image": img.to(device, non_blocking=True).permute(0, 3, 1, 2)
                    .contiguous(),
        "label": torch.from_numpy(np.asarray(batch["label"], np.int64))
                      .to(device, non_blocking=True),
        "weight": torch.from_numpy(np.asarray(batch["weight"], np.float32))
                       .to(device, non_blocking=True),
    }


def to_float(image: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [0,1]; float inputs pass through as fp32."""
    if image.dtype == torch.uint8:
        return image.to(torch.float32) / 255.0
    return image.to(torch.float32)


def draw_augment(gen: torch.Generator, batch_size: int, pad: int = 4):
    """Crop offsets in [0, 2·pad] (rows, cols) and flip flags for a batch,
    drawn on the generator's device."""
    offsets = torch.randint(0, 2 * pad + 1, (batch_size, 2), generator=gen,
                            device=gen.device)
    flips = torch.randint(0, 2, (batch_size,), generator=gen,
                          device=gen.device).bool()
    return offsets, flips


def augment(image: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor,
            pad: int = 4) -> torch.Tensor:
    """RandomCrop(size, padding=pad) with zero padding, then a horizontal
    flip, from given per-sample offsets ``[B, 2]`` (row, col) and flips
    ``[B]``. ``image`` is float NCHW. Pure selection: bitwise equal to
    ``salun.data.loader.augment`` fed the same offsets and flips."""
    b, c, h, w = image.shape
    padded = F.pad(image, (pad, pad, pad, pad))
    offsets = offsets.to(image.device, torch.int64)
    flips = flips.to(image.device, torch.bool)
    ar_h = torch.arange(h, device=image.device)
    ar_w = torch.arange(w, device=image.device)
    rows = offsets[:, :1] + ar_h[None, :]                       # [B, H]
    cols_fwd = offsets[:, 1:] + ar_w[None, :]
    cols_rev = offsets[:, 1:] + (w - 1) - ar_w[None, :]
    cols = torch.where(flips[:, None], cols_rev, cols_fwd)      # [B, W]
    n = torch.arange(b, device=image.device)[:, None, None]
    # [B, H, W, C] from advanced indexing around the channel slice
    out = padded.permute(0, 2, 3, 1)[n, rows[:, :, None], cols[:, None, :]]
    return out.permute(0, 3, 1, 2).contiguous()
