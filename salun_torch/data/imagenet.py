"""ImageNet-family loaders over a local HF ``DatasetDict`` (counterpart of
``salun/data/imagenet.py``; reference Classification/imagenet.py:14-194).

The data is a ``datasets.save_to_disk`` folder with ``train`` and
``validation`` splits of ``image``/``label`` rows. The port reads only
such a local folder: it never calls ``load_dataset``, which would fetch
from the hub. ``datasets`` is imported when a loader is built; where it is
not installed, the loader raises with instructions.

ImageNet does not fit in host memory as one array, so
:class:`ImageNetLoader` streams batch dicts: decoding runs on a thread pool
(``parallel_decode``) and batches come from a background queue
(``prefetch``), so host input overlaps the step.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from .pipeline import parallel_decode, prefetch


def load_dataset_dict(data_path: str):
    """The ``DatasetDict`` saved at ``data_path`` (``save_to_disk``)."""
    if not os.path.isdir(data_path):
        raise FileNotFoundError(
            f"{data_path} is not a local DatasetDict folder: save the data "
            "once with datasets' save_to_disk and pass that folder (the port "
            "does not download)")
    try:
        from datasets import load_from_disk
    except ImportError as e:
        raise ImportError(
            "ImageNet needs the `datasets` package (with pyarrow) to read "
            "a save_to_disk folder; install it where the data lives") from e
    return load_from_disk(data_path)


def get_x_y_from_data_dict(data: dict, as_numpy: bool = True):
    """(image, target) of a HF-style batch dict (imagenet.py:169-175)."""
    x, y = data["image"], data["label"]
    if as_numpy:
        x = np.asarray(x)
        y = np.asarray(y)
    return x, y


class ImageNetLoader:
    """Streaming train and validation loaders with class- or index-based
    forget marking (imagenet.py:135-166)."""

    def __init__(self, data_path: str, batch_size: int = 256,
                 image_size: int = 224, seed: int = 1,
                 decode_workers: Optional[int] = None,
                 prefetch_depth: int = 4):
        self.ds = load_dataset_dict(data_path)
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self._decoder = parallel_decode(self._resize, decode_workers)
        self.prefetch_depth = prefetch_depth

    def _resize(self, img):
        from PIL import Image

        img = img.convert("RGB").resize((self.image_size, self.image_size),
                                        Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _iter_split(self, split, indices=None, shuffle=True) -> Iterator[dict]:
        return prefetch(self._produce(split, indices, shuffle),
                        depth=self.prefetch_depth)

    def _produce(self, split, indices=None, shuffle=True) -> Iterator[dict]:
        """Batches of ``{"image" uint8 NHWC, "label" int32, "weight"}``;
        the last is padded to the batch size by repeating its rows, with
        weight 0 on the padding. An index array is shuffled in place, as
        in the JAX package: each pass over it starts from the last pass's
        order."""
        ds = self.ds[split]
        order = np.arange(len(ds)) if indices is None else np.asarray(indices)
        if shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            rows = ds[idx.tolist()]
            imgs = self._decoder.map(rows["image"])
            labels = np.asarray(rows["label"], np.int32)
            w = np.ones(len(idx), np.float32)
            if len(idx) < bs:
                rep = np.resize(np.arange(len(idx)), bs - len(idx))
                imgs = np.concatenate([imgs, imgs[rep]])
                labels = np.concatenate([labels, labels[rep]])
                w = np.concatenate([w, np.zeros(bs - len(idx), np.float32)])
            yield {"image": imgs, "label": labels, "weight": w}

    def forget_retain_indices(self, class_to_replace: int,
                              num_indexes_to_replace: Optional[int] = None):
        labels = np.asarray(self.ds["train"]["label"])
        if class_to_replace == -1:
            forget = np.arange(len(labels))
        else:
            forget = np.flatnonzero(labels == class_to_replace)
        if num_indexes_to_replace is not None:
            rng = np.random.RandomState(self.seed - 1)
            forget = rng.choice(forget, num_indexes_to_replace, replace=False)
        retain = np.setdiff1d(np.arange(len(labels)), forget)
        return forget, retain

    def loaders(self, class_to_replace: int,
                num_indexes_to_replace: Optional[int] = None):
        forget, retain = self.forget_retain_indices(
            class_to_replace, num_indexes_to_replace)
        return {
            "forget": lambda: self._iter_split("train", forget),
            "retain": lambda: self._iter_split("train", retain),
            "val": lambda: self._iter_split("validation", shuffle=False),
        }

    def close(self) -> None:
        self._decoder.close()
