"""One argparse surface for the classification workload (counterpart of
``salun/cli/args.py``).

The same flags as the JAX package (reference Classification/arg_parser.py:
4-145), plus ``--device``: the port runs on ``cuda`` unless asked for the
CPU, and raises when no card is present.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SalUn classification (PyTorch)")

    # Dataset
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--dataset", type=str, default="cifar10")
    p.add_argument("--input_size", type=int, default=32)
    p.add_argument("--data_dir", type=str, default="./tiny-imagenet-200")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_classes", type=int, default=10)

    # Architecture
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--imagenet_arch", action="store_true")
    p.add_argument("--train_y_file", type=str, default="./labels/train_ys.pth")
    p.add_argument("--val_y_file", type=str, default="./labels/val_ys.pth")

    # General
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel device count; only 0/1 (one device) "
                        "is ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    p.add_argument("--seed", default=2, type=int)
    p.add_argument("--train_seed", default=1, type=int)
    p.add_argument("--gpu", type=int, default=0,
                   help="unused; select the card with --device cuda:N")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="results/")
    p.add_argument("--model_path", type=str, default=None)

    # Training
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", default=0.1, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--epochs", default=182, type=int)
    p.add_argument("--warmup", default=0, type=int)
    p.add_argument("--print_freq", default=50, type=int)
    p.add_argument("--decreasing_lr", default="91,136")
    p.add_argument("--no-aug", dest="no_aug", action="store_true", default=False)
    p.add_argument("--no-l1-epochs", dest="no_l1_epochs", default=0, type=int)

    # Pruning
    p.add_argument("--prune", type=str, default="omp")
    p.add_argument("--pruning_times", default=1, type=int)
    p.add_argument("--rate", default=0.95, type=float)
    p.add_argument("--prune_type", default="rewind_lt", type=str)
    p.add_argument("--random_prune", action="store_true")
    p.add_argument("--rewind_epoch", default=0, type=int)
    p.add_argument("--rewind_pth", default=None, type=str)

    # Unlearn
    p.add_argument("--unlearn", type=str, default="retrain")
    p.add_argument("--unlearn_lr", default=0.01, type=float)
    p.add_argument("--unlearn_epochs", default=10, type=int)
    p.add_argument("--num_indexes_to_replace", type=int, default=None)
    p.add_argument("--class_to_replace", type=int, default=-1)
    p.add_argument("--indexes_to_replace", type=int, nargs="*", default=None)
    p.add_argument("--alpha", default=0.2, type=float)
    p.add_argument("--mask_path", default=None, type=str)
    p.add_argument("--mask_ratio", default=0.5, type=float)

    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)
