"""In-memory datasets (counterpart of ``salun/data/datasets.py``).

Every dataset is a pair of numpy arrays ``(data uint8 NHWC, targets int64)``,
as in the JAX package; batches become NCHW torch tensors on the device in
``salun_torch.data.loader``. Readers parse the standard on-disk formats:
CIFAR-10/100 python-pickle batches, SVHN ``.mat`` files (scipy), the
extracted TinyImageNet tree (PIL), ImageNet from a local HF
``save_to_disk`` folder (``salun_torch.data.imagenet``), plus the
deterministic synthetic stand-in.
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


def cifar100(data_dir: str, train: bool = True) -> ArrayDataset:
    """Parse CIFAR-100 python batches (cifar-100-python), fine labels."""
    base = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(base):
        _maybe_extract(data_dir, "cifar-100-python.tar.gz")
    d = _cifar_unpickle(os.path.join(base, "train" if train else "test"))
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(data),
                        np.asarray(d[b"fine_labels"], np.int64), 100,
                        "cifar100")


def svhn(data_dir: str, train: bool = True) -> ArrayDataset:
    """Parse SVHN ``train_32x32.mat`` / ``test_32x32.mat``: X is HWCN,
    label 10 stands for digit 0."""
    import scipy.io

    fn = os.path.join(data_dir,
                      "train_32x32.mat" if train else "test_32x32.mat")
    mat = scipy.io.loadmat(fn)
    data = mat["X"].transpose(3, 0, 1, 2)  # HWCN → NHWC
    labels = mat["y"].astype(np.int64).reshape(-1)
    labels[labels == 10] = 0
    return ArrayDataset(np.ascontiguousarray(data), labels, 10, "svhn")


def tiny_imagenet(data_dir: str, train: bool = True) -> ArrayDataset:
    """Read the extracted tiny-imagenet-200 tree: classes by sorted wnid
    (the reference's ImageFolder order, dataset.py:372-430), train images
    by sorted file name, val images in ``val_annotations.txt`` order."""
    from PIL import Image

    with open(os.path.join(data_dir, "wnids.txt")) as f:
        wnids = sorted(f.read().split())
    cls_of = {w: i for i, w in enumerate(wnids)}
    files, ys = [], []
    if train:
        for w in wnids:
            img_dir = os.path.join(data_dir, "train", w, "images")
            for fn in sorted(os.listdir(img_dir)):
                files.append(os.path.join(img_dir, fn))
                ys.append(cls_of[w])
    else:
        with open(os.path.join(data_dir, "val", "val_annotations.txt")) as f:
            for line in f:
                fn, w = line.split("\t")[:2]
                files.append(os.path.join(data_dir, "val", "images", fn))
                ys.append(cls_of[w])
    xs = []
    for fn in files:
        with Image.open(fn) as img:
            xs.append(np.asarray(img.convert("RGB"), np.uint8))
    return ArrayDataset(np.stack(xs), np.asarray(ys, np.int64), 200,
                        "tiny_imagenet")


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


def imagenet(data_dir: str, train: bool = True) -> ArrayDataset:
    """ImageNet-1k from a local HF ``DatasetDict`` folder
    (``datasets.save_to_disk``; reference Classification/imagenet.py:
    135-166). It decodes the whole split into one array, so it serves
    subsets and miniatures through the standard CLIs (``main_forget
    --dataset imagenet``); a full-scale run streams through
    :class:`~salun_torch.data.imagenet.ImageNetLoader`. The decode size is
    ``SALUN_IMAGENET_SIZE`` (default 224, the reference's)."""
    from .imagenet import ImageNetLoader

    size = int(os.environ.get("SALUN_IMAGENET_SIZE", "224"))
    loader = ImageNetLoader(data_dir, image_size=size)
    try:
        ds = loader.ds["train" if train else "validation"]
        xs = np.stack([loader._resize(im) for im in ds["image"]])
        ys = np.asarray(ds["label"], np.int64)
    finally:
        loader.close()
    return ArrayDataset(xs, ys, 1000, "imagenet")


REGISTRY = {"cifar10": cifar10, "cifar100": cifar100, "svhn": svhn,
            "TinyImagenet": tiny_imagenet, "tiny_imagenet": tiny_imagenet,
            "imagenet": imagenet}


def load(name: str, data_dir: str, train: bool = True) -> ArrayDataset:
    if name == "synthetic":
        return synthetic(n=2048 if train else 512, seed=0 if train else 1)
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}")
    return REGISTRY[name](data_dir, train=train)
