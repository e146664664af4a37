"""Model and dataset factory plus the forget/retain loaders shared by the
unlearn drivers (counterpart of ``salun/cli/setup.py``; reference
Classification/utils.py:112-285, main_random.py:50-110)."""

from __future__ import annotations

import numpy as np

from salun_torch.ckpt import load_state_dict
from salun_torch.data import datasets as D
from salun_torch.data.loader import BatchIterator
from salun_torch.data.splits import (drop_class, forget_retain_split,
                                     replace_class, replace_indexes,
                                     validation_split)
from salun_torch.models import create_model


def setup_model_dataset(args, device, init_seed: int):
    """Returns ``(model, train_full, val, test, marked)`` as the reference
    factory does; the model is built on ``device`` with a seeded init."""
    name = args.dataset
    no_val = name.endswith("_no_val")
    if no_val:
        name = name[: -len("_no_val")]
    num_classes = {"cifar10": 10, "svhn": 10, "synthetic": 10,
                   "cifar100": 100, "TinyImagenet": 200, "tiny_imagenet": 200,
                   "imagenet": 1000}.get(name)
    if num_classes is None:
        raise KeyError(name)
    args.num_classes = num_classes
    if args.dp not in (0, 1):
        raise NotImplementedError("--dp > 1 is not ported yet")

    train = D.load(name, args.data, train=True)
    test = D.load(name, args.data, train=False)

    if name in ("cifar10", "cifar100", "svhn") and not no_val:
        train, val = validation_split(train, seed=args.seed)
    else:
        val = test

    marked = train.copy()
    if args.class_to_replace is not None and args.indexes_to_replace:
        raise ValueError("only one of class/indexes_to_replace")
    if args.indexes_to_replace:
        marked = replace_indexes(marked, np.asarray(args.indexes_to_replace),
                                 seed=args.seed - 1, only_mark=True)
    elif args.class_to_replace is not None:
        marked = replace_class(
            marked, args.class_to_replace,
            num_indexes_to_replace=args.num_indexes_to_replace,
            seed=args.seed - 1, only_mark=True)
        if args.class_to_replace >= 0 and (
                args.num_indexes_to_replace is None
                or args.num_indexes_to_replace == 4500):
            test = drop_class(test, args.class_to_replace)

    model = create_model(args.arch, num_classes, imagenet=args.imagenet_arch,
                         seed=init_seed, device=device)
    return model, train, val, test, marked


def load_model(model, path: str) -> None:
    """Load a reference-format torch checkpoint into ``model`` (strict:
    every parameter and BatchNorm statistic must be present)."""
    sd = load_state_dict(path)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v  # older checkpoints omit the counter
    model.load_state_dict(sd, strict=True)


def build_unlearn_loaders(args, train, val, test, marked):
    """forget/retain/val/test loader dict (main_random.py:50-110)."""
    forget, retain = forget_retain_split(marked)
    if len(forget) + len(retain) != len(train):
        raise ValueError("forget and retain do not cover the train set")
    return {
        "forget": BatchIterator(forget, args.batch_size, shuffle=True,
                                seed=args.seed),
        "retain": BatchIterator(retain, args.batch_size, shuffle=True,
                                seed=args.seed),
        "val": BatchIterator(val, args.batch_size, shuffle=False),
        "test": BatchIterator(test, args.batch_size, shuffle=False),
    }, forget, retain
