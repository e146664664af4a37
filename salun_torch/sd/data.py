"""SD workload data: counterpart of ``salun/sd/data.py`` (reference
SD/train-scripts/dataset.py:36-176).

Imagenette from an extracted ``imagenette2/<split>/<wnid>/`` folder, or
the deterministic synthetic stand-in, with the reference's prompt
templates ("an image of a {label}") and the forget/remain split; the flat
NSFW / not-NSFW folders of generated images with their prompt pair. Images
are resized (bicubic) and center-cropped to ``image_size``, kept as uint8
NHWC, and scaled to [−1, 1] at use (get_transform, dataset.py:23-33). The
HF-cache branch of the JAX package (``datasets``) waits (ROADMAP queue 1,
item 4).
"""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np
import torch

from salun_torch.data.datasets import ArrayDataset, synthetic

IMAGENETTE_CLASSES = [
    "tench", "english springer", "cassette player", "chain saw", "church",
    "french horn", "garbage truck", "gas pump", "golf ball", "parachute",
]

DESCRIPTIONS = [f"an image of a {label}" for label in IMAGENETTE_CLASSES]

# NSFW-removal prompt pair (nsfw_removal.py:83-104)
WORD_NUDE = "a photo of a nude person"
WORD_WEAR = "a photo of a person wearing clothes"


def _resize_center_crop(img, size: int) -> np.ndarray:
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, int(round(w * scale))),
                      max(size, int(round(h * scale)))), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size)).convert("RGB")
    return np.asarray(img, np.uint8)


def load_imagenette(data_dir: str, image_size: int = 512,
                    split: str = "train") -> ArrayDataset:
    """``data_dir/imagenette2/<split>/<wnid>/*`` (classes in sorted wnid
    order), or 64 synthetic images when that folder is missing."""
    folder = os.path.join(data_dir, "imagenette2", split)
    if not os.path.isdir(folder):
        return synthetic(n=64, num_classes=10, image_size=image_size, seed=7)
    from PIL import Image

    xs, ys = [], []
    for ci, wnid in enumerate(sorted(os.listdir(folder))):
        for fn in sorted(os.listdir(os.path.join(folder, wnid))):
            with Image.open(os.path.join(folder, wnid, fn)) as img:
                xs.append(_resize_center_crop(img, image_size))
            ys.append(ci)
    return ArrayDataset(np.stack(xs), np.asarray(ys, np.int64), 10,
                        "imagenette")


def forget_remain_split(ds: ArrayDataset, class_to_forget: int):
    forget = ds.select(np.flatnonzero(ds.targets == class_to_forget))
    remain = ds.select(np.flatnonzero(ds.targets != class_to_forget))
    return forget, remain


def load_image_folder(root: str, image_size: int = 512) -> ArrayDataset:
    """A flat folder of PNG/JPEG images (sorted names; the NSFW and
    not-NSFW generated sets), resized and center-cropped, label 0."""
    from PIL import Image

    xs = []
    for fn in sorted(os.listdir(root)):
        if not fn.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        with Image.open(os.path.join(root, fn)) as img:
            xs.append(_resize_center_crop(img, image_size))
    return ArrayDataset(np.stack(xs), np.zeros(len(xs), np.int64), 1, root)


def to_pm1(batch_images, device="cpu") -> torch.Tensor:
    """uint8 NHWC → float NCHW in [−1, 1] (Normalize([0.5], [0.5]) after
    ToTensor) on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(batch_images)).to(device)
    return (x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
            ).contiguous()


def read_prompts_csv(path: str) -> List[dict]:
    """prompts/*.csv rows: case_number,prompt,evaluation_seed[,class,
    classidx] (SD/prompts/imagenette.csv)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        return list(csv.DictReader(f))
