"""Forget/retain/validation splitting (counterpart of
``salun/data/splits.py``, numpy only, the same draws).

- 10%-per-class validation split from ``np.random.RandomState(seed)``
  (Classification/dataset.py:576-593);
- ``replace_class`` / ``replace_indexes`` with ``only_mark`` encoding
  forget targets as ``-(y+1)`` (dataset.py:648-705);
- ``forget_retain_split`` recovering the two sets from a marked dataset.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Optional, Tuple

import numpy as np

from .datasets import ArrayDataset


def validation_split(train: ArrayDataset, seed: int = 1,
                     fraction: float = 0.1) -> Tuple[ArrayDataset, ArrayDataset]:
    rng = np.random.RandomState(seed)
    valid_idx = []
    for c in range(int(train.targets.max()) + 1):
        class_idx = np.where(train.targets == c)[0]
        valid_idx.append(
            rng.choice(class_idx, int(fraction * len(class_idx)), replace=False))
    valid_idx = np.hstack(valid_idx)
    train_idx = np.array(sorted(set(range(len(train))) - set(valid_idx.tolist())))
    return train.select(train_idx), train.select(valid_idx)


def replace_indexes(ds: ArrayDataset, indexes: np.ndarray, seed: int = 0,
                    only_mark: bool = False) -> ArrayDataset:
    """Mark (or replace) the given indices (dataset.py:648-671)."""
    ds = ds.copy()
    indexes = np.asarray(indexes)
    if only_mark:
        ds.targets[indexes] = -ds.targets[indexes] - 1
    else:
        rng = np.random.RandomState(seed)
        others = np.array(sorted(set(range(len(ds))) - set(indexes.tolist())))
        new_indexes = rng.choice(others, size=len(indexes))
        ds.data[indexes] = ds.data[new_indexes]
        ds.targets[indexes] = ds.targets[new_indexes]
    return ds


def replace_class(ds: ArrayDataset, class_to_replace: int,
                  num_indexes_to_replace: Optional[int] = None, seed: int = 0,
                  only_mark: bool = False) -> ArrayDataset:
    """Mark/replace samples of one class, or a random subset of all
    samples when ``class_to_replace == -1`` (dataset.py:674-705)."""
    if class_to_replace == -1:
        indexes = np.arange(len(ds))
    else:
        indexes = np.flatnonzero(ds.targets == class_to_replace)
    if num_indexes_to_replace is not None:
        if num_indexes_to_replace > len(indexes):
            raise ValueError(f"cannot mark {num_indexes_to_replace} of "
                             f"{len(indexes)} samples")
        rng = np.random.RandomState(seed)
        indexes = rng.choice(indexes, size=num_indexes_to_replace,
                             replace=False)
    return replace_indexes(ds, indexes, seed, only_mark)


def forget_retain_split(marked: ArrayDataset) -> Tuple[ArrayDataset, ArrayDataset]:
    """Forget = the negative-encoded samples, labels restored as
    ``y = -t - 1`` (main_random.py:62-77); retain = the rest."""
    is_forget = marked.targets < 0
    forget = marked.select(np.flatnonzero(is_forget))
    forget = dc_replace(forget, targets=-forget.targets - 1)
    retain = marked.select(np.flatnonzero(~is_forget))
    return forget, retain


def drop_class(ds: ArrayDataset, cls: int) -> ArrayDataset:
    """Remove one class entirely (test-set filtering, dataset.py:606-609)."""
    return ds.select(np.flatnonzero(ds.targets != cls))
