"""Pretraining CLI (counterpart of ``salun/cli/main_train.py``;
reference Classification/main_train.py:30-159).

SGD with momentum and MultiStepLR (γ = 0.1 at ``--decreasing_lr``), or
per-epoch cosine warmup for ``--imagenet_arch``; per-epoch validation and
test accuracy; ``checkpoint.pt`` every epoch, ``model_SA_best.pt`` (the
reference's ``{"state_dict": ...}`` layout) whenever the validation
accuracy improves, and ``train_curves.json`` at the end.

``--resume`` continues from ``checkpoint.pt``: model, flat momentum and
step count (the lr schedule is a function of it), the step-randomness
generator, epoch, best SA and curves. Each epoch's shuffle order is a
function of (``--train_seed``, epoch), so a resumed run takes the steps a
straight run takes and ends bitwise equal to it where the kernels are
deterministic (always on the CPU).

``--dp N`` under ``torchrun --nproc_per_node N`` shards each batch over N
ranks (``salun_torch.dist.context``); rank 0 writes.

Usage: python -m salun_torch.cli.main_train --dataset cifar10 \
           --arch resnet18 --epochs 182 --save_dir out/ [--resume] \
           [--device cpu]
"""

from __future__ import annotations

import json
import os
import time

import torch

from salun_torch.ckpt import load_train_state, save_model, save_train_state
from salun_torch.cli.args import parse_args
from salun_torch.cli.setup import setup_model_dataset
from salun_torch.core.masked_opt import SGD, FlatParams
from salun_torch.core.train import (cosine_warmup_lr, generator_source,
                                    multistep_lr, run_epoch, validate)
from salun_torch.data.loader import BatchIterator
from salun_torch.dist import context as dist_ctx
from salun_torch.utils.device import make_generator, seed_all, set_tf32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the epochs; returns ``{"curves", "best_sa", "epoch_seconds",
    "images_per_epoch"}``."""
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _main(args, device) -> dict:
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    model, train, val, test, _ = setup_model_dataset(args, device, args.seed)
    loader = BatchIterator(train, args.batch_size, shuffle=True,
                           seed=args.train_seed)
    steps_per_epoch = len(loader)
    if args.imagenet_arch:
        sched = cosine_warmup_lr(args.lr, args.warmup, args.epochs,
                                 steps_per_epoch)
    else:
        milestones = [int(x) for x in args.decreasing_lr.split(",") if x]
        sched = multistep_lr(args.lr, milestones, steps_per_epoch)
    opt = SGD(FlatParams(model.parameters()), sched, args.momentum,
              args.weight_decay)
    gen = make_generator(args.seed, device)
    source = generator_source(gen, args.num_classes)

    best_sa, start_epoch = 0.0, 0
    curves = {"train_acc": [], "val_acc": [], "test_acc": []}
    ckpt_path = os.path.join(args.save_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        saved = load_train_state(ckpt_path, model, opt, gen)
        start_epoch, best_sa, curves = (saved["epoch"], saved["best_sa"],
                                        saved["curves"])
        print(f"resume from {ckpt_path} at epoch {start_epoch} "
              f"(best_sa={best_sa:.2f})")
    dist_ctx.place_replicated(model)

    val_loader = BatchIterator(val, args.batch_size, shuffle=False)
    test_loader = BatchIterator(test, args.batch_size, shuffle=False)
    epoch_seconds = []
    for epoch in range(start_epoch, args.epochs):
        _sync(device)
        t0 = time.perf_counter()
        loader.set_epoch(epoch)
        m = run_epoch(model, opt, loader, source, device,
                      use_augment=not args.no_aug)
        _sync(device)
        epoch_seconds.append(time.perf_counter() - t0)
        train_acc = float(m["acc"])
        val_acc = validate(model, val_loader, device)
        test_acc = validate(model, test_loader, device)
        for k, v in (("train_acc", train_acc), ("val_acc", val_acc),
                     ("test_acc", test_acc)):
            curves[k].append(v)
        print(f"epoch {epoch} train {train_acc:.2f} val {val_acc:.2f} "
              f"test {test_acc:.2f} ({epoch_seconds[-1]:.3f}s, "
              f"{len(train) / epoch_seconds[-1]:.1f} img/s)")

        is_best = val_acc > best_sa
        best_sa = max(val_acc, best_sa)
        if dist_ctx.is_writer():
            save_train_state(ckpt_path, model, opt, gen, epoch=epoch + 1,
                             best_sa=best_sa, curves=curves)
            if is_best:
                save_model(os.path.join(args.save_dir, "model_SA_best.pt"),
                           model)

    dist_ctx.check_replicas(model.state_dict().values(), "parameters")
    if dist_ctx.is_writer():
        with open(os.path.join(args.save_dir, "train_curves.json"),
                  "w") as f:
            json.dump(curves, f)
    dist_ctx.barrier()
    return {"curves": curves, "best_sa": best_sa,
            "epoch_seconds": epoch_seconds, "images_per_epoch": len(train)}


if __name__ == "__main__":
    main()
