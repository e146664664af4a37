"""In-memory datasets (counterpart of ``salun/data/datasets.py``).

Every dataset is a pair of numpy arrays ``(data uint8 NHWC, targets int64)``,
as in the JAX package; batches become NCHW torch tensors on the device in
``salun_torch.data.loader``. Ported readers: CIFAR-10 (python-pickle
batches) and the deterministic synthetic stand-in. CIFAR-100, SVHN,
TinyImageNet and ImageNet wait for later slices.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from dataclasses import dataclass, replace as dc_replace

import numpy as np


@dataclass
class ArrayDataset:
    """In-memory dataset: images uint8 [N,H,W,C], integer targets [N]."""

    data: np.ndarray
    targets: np.ndarray
    num_classes: int
    name: str = ""

    def __len__(self):
        return len(self.data)

    def select(self, idx) -> "ArrayDataset":
        return dc_replace(self, data=self.data[idx], targets=self.targets[idx])

    def copy(self) -> "ArrayDataset":
        return dc_replace(self, data=self.data.copy(), targets=self.targets.copy())


def _cifar_unpickle(path):
    # The files are CIFAR-10's own python pickles (cifar-10-batches-py).
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _maybe_extract(data_dir: str, archive: str):
    path = os.path.join(data_dir, archive)
    if os.path.exists(path):
        with tarfile.open(path) as tf:
            tf.extractall(data_dir, filter="data")


def cifar10(data_dir: str, train: bool = True) -> ArrayDataset:
    """Parse CIFAR-10 python batches (cifar-10-batches-py)."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        _maybe_extract(data_dir, "cifar-10-python.tar.gz")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for fn in files:
        d = _cifar_unpickle(os.path.join(base, fn))
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(data), np.asarray(ys, np.int64),
                        10, "cifar10")


def synthetic(n: int = 512, num_classes: int = 10, image_size: int = 32,
              seed: int = 0, class_signal: float = 0.25) -> ArrayDataset:
    """Deterministic learnable synthetic data (per-class mean + noise),
    the same arrays as ``salun.data.datasets.synthetic`` for the same
    arguments: low-frequency, horizontally symmetric class means that
    survive crop ±4 and flips, plus uniform noise."""
    rng = np.random.default_rng(seed)
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
    means = 0.5 * (smooth + smooth[:, :, ::-1])
    ys = rng.integers(0, num_classes, n)
    noise = rng.uniform(-1.0, 1.0, (n, image_size, image_size, 3))
    imgs = (means[ys] * class_signal + 0.5 * (1 - class_signal)
            + noise * 0.2 * (1 - class_signal))
    data = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    return ArrayDataset(data, ys.astype(np.int64), num_classes, "synthetic")


REGISTRY = {"cifar10": cifar10}
NOT_PORTED = ("cifar100", "svhn", "TinyImagenet", "tiny_imagenet", "imagenet")


def load(name: str, data_dir: str, train: bool = True) -> ArrayDataset:
    if name == "synthetic":
        return synthetic(n=2048 if train else 512, seed=0 if train else 1)
    if name in NOT_PORTED:
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}")
    return REGISTRY[name](data_dir, train=train)
