"""DDPM workload data (counterpart of ``salun/data/ddpm_data.py``;
reference DDPM/datasets/__init__.py:30-298): the dataset by name (CIFAR-10,
STL-10's binary files, the synthetic stand-in) resized with PIL's bilinear
filter where the config's ``image_size`` differs, the retain/forget class
split, folders of images (the SA remember set of generated class samples),
the FID reference subset, the endless batch stream and the per-sample
horizontal flip of the train-side loaders.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .datasets import ArrayDataset, cifar10, synthetic
from .loader import BatchIterator


def get_dataset(name: str, data_dir: str, train: bool = True,
                image_size: Optional[int] = None) -> ArrayDataset:
    """Dataset by name, resized to ``image_size`` where it differs, as the
    reference's ``transforms.Resize(config.data.image_size)``
    (DDPM/datasets/__init__.py:36,41; STL-10 trains at 64, not its native
    96)."""
    if name.lower() == "cifar10":
        ds = cifar10(data_dir, train)
    elif name.lower() == "stl10":
        ds = stl10(data_dir, train)
    elif name == "synthetic":
        ds = synthetic(n=512 if train else 128)
    else:
        raise KeyError(name)
    if image_size and ds.data.shape[1] != image_size:
        ds = ArrayDataset(resize_images(ds.data, image_size), ds.targets,
                          ds.num_classes, ds.name)
    return ds


def resize_images(images_u8: np.ndarray, size: int) -> np.ndarray:
    """NHWC uint8 images resized to ``size``² with PIL's bilinear filter
    (torchvision ``Resize``'s default interpolation)."""
    from PIL import Image

    out = np.empty((len(images_u8), size, size, images_u8.shape[-1]),
                   np.uint8)
    for i, img in enumerate(images_u8):
        out[i] = np.asarray(
            Image.fromarray(img).resize((size, size), Image.BILINEAR))
    return out


def stl10(data_dir: str, train: bool = True) -> ArrayDataset:
    """STL-10's binary files ``stl10_binary/{train,test}_{X,y}.bin``: X is
    uint8 [N, 3, 96, 96] stored column-major per channel, so (C, W, H) →
    (H, W, C); y holds labels 1…10."""
    base = os.path.join(data_dir, "stl10_binary")
    split = "train" if train else "test"
    x = np.fromfile(os.path.join(base, f"{split}_X.bin"), np.uint8)
    y = np.fromfile(os.path.join(base, f"{split}_y.bin"), np.uint8)
    x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
    return ArrayDataset(np.ascontiguousarray(x), (y - 1).astype(np.int64), 10,
                        "stl10")


def get_forget_dataset(ds: ArrayDataset, label_to_forget: int
                       ) -> Tuple[ArrayDataset, ArrayDataset]:
    """(remain, forget) class split (datasets/__init__.py:120-177)."""
    forget_idx = np.flatnonzero(ds.targets == label_to_forget)
    remain_idx = np.flatnonzero(ds.targets != label_to_forget)
    return ds.select(remain_idx), ds.select(forget_idx)


def _read_image(path: str, image_size: Optional[int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if image_size:
        img = img.resize((image_size, image_size))  # PIL's default filter
    return np.asarray(img, np.uint8)


def image_folder_dataset(root: str, image_size: Optional[int] = None,
                         label: int = 0) -> ArrayDataset:
    """A folder of images as arrays (the reference's ``ImagePathDataset``,
    datasets/__init__.py:270-290). Subfolders named by class index give
    the labels (the ``class_samples`` layout ``ddpm_sample`` writes); a
    flat folder takes ``label``. Files are read in ``sorted(os.listdir)``
    order ("10.png" before "2.png"), as the JAX reader does."""
    xs, ys = [], []
    entries = sorted(os.listdir(root))
    subdirs = [e for e in entries if os.path.isdir(os.path.join(root, e))]
    if subdirs:
        for d in subdirs:
            try:
                cls = int(d)
            except ValueError:
                cls = subdirs.index(d)
            for fn in sorted(os.listdir(os.path.join(root, d))):
                xs.append(_read_image(os.path.join(root, d, fn), image_size))
                ys.append(cls)
    else:
        for fn in entries:
            xs.append(_read_image(os.path.join(root, fn), image_size))
            ys.append(label)
    return ArrayDataset(np.stack(xs), np.asarray(ys, np.int64),
                        int(max(ys)) + 1, root)


def all_but_one_class_dataset(ds: ArrayDataset, label_to_forget: int
                              ) -> ArrayDataset:
    """The SA remember set: every class but the forgotten one
    (``all_but_one_class_path_dataset``)."""
    return ds.select(np.flatnonzero(ds.targets != label_to_forget))


def save_base_dataset(ds: ArrayDataset, excluded_class: int,
                      per_class: int = 500) -> ArrayDataset:
    """The FID reference set: the first ``per_class`` images of every class
    but ``excluded_class``, class by class (save_base_dataset.py:34-115)."""
    keep = [np.flatnonzero(ds.targets == c)[:per_class]
            for c in range(ds.num_classes) if c != excluded_class]
    return ds.select(np.concatenate(keep))


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
