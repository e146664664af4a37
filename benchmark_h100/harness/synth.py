"""Synthetic inputs, made from the run's seed.

Every draw comes from a generator seeded by the run's seed and a tag
(``generator(seed, "step", 7)``), so the benchmark and its reference make
the same inputs for the same seed and tag, and no file is read.

- CIFAR-shaped class images: the generation of the repository's synthetic
  CIFAR-10 files (``salun_torch.data.datasets.synthetic`` writes them):
  low-frequency, horizontally symmetric class means plus uniform noise,
  uint8 NHWC; the noise drawn on the device.
- SD training images: a smooth field (bilinear from 16×16) plus a little
  noise, in [−1, 1], NCHW, drawn on the device.
- CLIP token ids: BOS, a run of ids drawn from the vocabulary, EOS, then
  EOS padding to 77, as the tokenizer lays out a prompt.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS = 49406, 49407


def tag_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and tags."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, *tags, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(tag_seed(seed, *tags))
    return gen


def class_means(seed: int, num_classes: int = 10, image_size: int = 32):
    """[classes, H, W, 3] float64 class means in [0.1, 0.9]: a coarse 4×4
    grid, blown up, smoothed by a box filter and made left-right
    symmetric."""
    rng = np.random.default_rng(tag_seed(seed, "class_means"))
    coarse = rng.uniform(0.1, 0.9, (num_classes, 4, 4, 3))
    reps = (image_size + 3) // 4
    blocky = np.kron(coarse, np.ones((1, reps, reps, 1)))[
        :, :image_size, :image_size, :]
    k = max(image_size // 8, 1)
    kernel = np.ones(2 * k + 1) / (2 * k + 1)
    smooth = blocky
    for axis in (1, 2):
        smooth = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), axis, smooth)
    return 0.5 * (smooth + smooth[:, :, ::-1])


def class_images(seed: int, per_class: int, num_classes: int = 10,
                 image_size: int = 32, device="cpu",
                 class_signal: float = 0.25):
    """``per_class`` images of every class, class by class: (uint8 NHWC
    numpy images, int64 numpy labels)."""
    means = torch.as_tensor(class_means(seed, num_classes, image_size),
                            dtype=torch.float32, device=device)
    labels = torch.arange(num_classes, device=device).repeat_interleave(
        per_class)
    noise = torch.rand((len(labels), image_size, image_size, 3),
                       generator=generator(seed, "class_noise",
                                           device=device),
                       device=device) * 2.0 - 1.0
    imgs = (means[labels] * class_signal + 0.5 * (1 - class_signal)
            + noise * 0.2 * (1 - class_signal))
    data = (imgs.clamp(0, 1) * 255).to(torch.uint8)
    return data.cpu().numpy(), labels.cpu().numpy()


def sd_images(gen: torch.Generator, n: int, size: int, device):
    """[n, 3, size, size] images in [−1, 1]."""
    coarse = torch.rand((n, 3, 16, 16), generator=gen, device=device)
    smooth = F.interpolate(coarse, size=(size, size), mode="bilinear",
                           align_corners=False)
    noise = torch.rand((n, 3, size, size), generator=gen, device=device)
    return (0.9 * smooth + 0.1 * noise) * 2.0 - 1.0


def prompt_ids(gen: torch.Generator, n: int, device, length: int = 77,
               vocab: int = 49406, words=(3, 12)):
    """[n, length] int64 ids: BOS, ``words`` ids drawn from [0, vocab),
    EOS, EOS padding."""
    ids = torch.full((n, length), EOS, dtype=torch.long, device=device)
    ids[:, 0] = BOS
    counts = torch.randint(words[0], words[1] + 1, (n,), generator=gen,
                           device=device)
    body = torch.randint(0, vocab, (n, length - 2), generator=gen,
                         device=device)
    pos = torch.arange(length - 2, device=device)[None, :]
    ids[:, 1:-1] = torch.where(pos < counts[:, None], body, EOS)
    return ids


def null_ids(n: int, device, length: int = 77):
    """The empty prompt: BOS, then EOS to the end."""
    ids = torch.full((n, length), EOS, dtype=torch.long, device=device)
    ids[:, 0] = BOS
    return ids
