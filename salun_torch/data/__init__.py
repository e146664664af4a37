from .datasets import (ArrayDataset, cifar10, cifar100, load, svhn, synthetic,
                       tiny_imagenet)
from .loader import BatchIterator, augment, draw_augment, to_device, to_float
from .splits import (drop_class, forget_retain_split, replace_class,
                     replace_indexes, validation_split)

__all__ = [
    "ArrayDataset", "BatchIterator", "augment", "cifar10", "cifar100",
    "draw_augment",
    "drop_class", "forget_retain_split", "load", "replace_class",
    "replace_indexes", "svhn", "synthetic", "tiny_imagenet", "to_device",
    "to_float",
    "validation_split",
]
