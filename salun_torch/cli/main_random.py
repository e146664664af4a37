"""SalUn unlearning driver, masked methods (counterpart of
``salun/cli/main_random.py``; reference Classification/main_random.py:
15-188).

Loads θ and the saliency mask, runs any of the 17 unlearning methods
with the mask (RL, GA, GA_l1, FT, FT_l1, FT_prune, boundary_shrink and
boundary_expanding: masked SGD, one launch of kernel K1 per step on the
card; wfisher multiplies its perturbation by the mask; ``retrain``
starts from the seeded init and ignores θ and the mask; the others ignore
the mask), then evaluates UA/RA/TA and the SVC-MIA forget efficacy of the
model the method returns (for boundary_expanding the model with one more
output) and writes ``{unlearn}_checkpoint.pt`` and
``{unlearn}_eval_result.json``.
With ``--resume`` and an existing ``{unlearn}_checkpoint.pt``, the
unlearned model is loaded and the unlearning loop skipped; the evaluation
is computed anew (main_random.py:122-126). ``main_forget`` is this CLI
without the mask. ``--dp N`` under ``torchrun --nproc_per_node N`` shards
each batch over N ranks (``salun_torch.dist.context``); every rank returns
the same results, and rank 0 writes.

Usage: python -m salun_torch.cli.main_random --unlearn RL \
           --mask_path masks/with_0.5.pt --model_path model.pt \
           --unlearn_lr 0.013 --unlearn_epochs 10 [--resume] [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from salun_torch.ckpt import (checkpoint_path, load_mask, save_checkpoint,
                             save_eval_results)
from salun_torch.cli.args import parse_args
from salun_torch.cli.setup import (build_unlearn_loaders, load_model,
                                   setup_model_dataset)
from salun_torch.core.methods import UnlearnConfig, get_unlearn_method
from salun_torch.core.train import generator_source, validate
from salun_torch.data.loader import BatchIterator
from salun_torch.dist import context as dist_ctx
from salun_torch.evalx import SVC_MIA
from salun_torch.utils.device import make_generator, seed_all, set_tf32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None, use_mask=True) -> dict:
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device,
                        lambda dev: _run(args, dev, use_mask))


def _run(args, device, use_mask: bool) -> dict:
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    model, train, val, test, marked = setup_model_dataset(args, device,
                                                          args.train_seed)
    loaders, forget, retain = build_unlearn_loaders(args, train, val, test,
                                                    marked)
    print(f"number of retain dataset {len(retain)}")
    print(f"number of forget dataset {len(forget)}")
    if args.model_path and args.unlearn != "retrain":
        load_model(model, args.model_path)
    dist_ctx.place_replicated(model)

    mask = None
    if use_mask and args.mask_path:
        mask = load_mask(args.mask_path, device)

    cfg = UnlearnConfig(
        dataset=args.dataset, num_classes=args.num_classes, arch=args.arch,
        imagenet_arch=args.imagenet_arch, unlearn_lr=args.unlearn_lr,
        unlearn_epochs=args.unlearn_epochs, momentum=args.momentum,
        weight_decay=args.weight_decay, decreasing_lr=args.decreasing_lr,
        warmup=args.warmup, batch_size=args.batch_size, alpha=args.alpha,
        no_l1_epochs=args.no_l1_epochs, mask_ratio=args.mask_ratio,
        class_to_replace=args.class_to_replace,
        num_indexes_to_replace=args.num_indexes_to_replace,
        rate=args.rate, random_prune=args.random_prune, seed=args.seed,
        print_freq=args.print_freq,
    )

    unlearn_ckpt = checkpoint_path(args.save_dir, args.unlearn)
    _sync(device)
    t0 = time.perf_counter()
    if args.resume and os.path.exists(unlearn_ckpt):
        print(f"resume from unlearn checkpoint {unlearn_ckpt}")
        load_model(model, unlearn_ckpt)
        dist_ctx.place_replicated(model)
    else:
        method = get_unlearn_method(args.unlearn)
        source = generator_source(make_generator(args.train_seed, device),
                                  cfg.num_classes)
        model, _ = method(loaders, model, cfg, mask=mask, device=device,
                          source=source)
    _sync(device)
    t_unlearn = time.perf_counter() - t0

    # UA/RA/TA (main_random.py:146-155)
    results = {}
    for name in ("retain", "forget", "val", "test"):
        results[name] = validate(model, loaders[name], device)
        print(f"{name} acc: {results[name]:.2f}")
    results["UA"] = 100.0 - results["forget"]
    t_acc = time.perf_counter() - t0 - t_unlearn

    # MIA forget efficacy (main_random.py:165-186): shadow_train =
    # retain[:len(test)], shadow_test = test, target = forget
    n_shadow = min(len(test), len(retain))
    shadow_train = BatchIterator(retain.select(np.arange(n_shadow)),
                                 args.batch_size, shuffle=False)
    mia = SVC_MIA(model, shadow_train=shadow_train,
                  shadow_test=loaders["test"], target_train=None,
                  target_test=loaders["forget"], device=device)
    results["SVC_MIA_forget_efficacy"] = mia
    print("SVC_MIA_forget_efficacy:", mia)
    t_mia = time.perf_counter() - t0 - t_unlearn - t_acc
    results["seconds"] = {"unlearn": t_unlearn, "accuracy": t_acc,
                          "mia": t_mia}
    print(f"seconds: unlearn {t_unlearn:.3f}, accuracy {t_acc:.3f}, "
          f"SVC-MIA {t_mia:.3f}")

    dist_ctx.check_replicas(model.state_dict().values(), "parameters")
    if dist_ctx.is_writer():
        save_checkpoint(args.save_dir, args.unlearn, model)
        save_eval_results(args.save_dir, args.unlearn, results)
    dist_ctx.barrier()
    return results


def main(argv=None):
    return run(argv, use_mask=True)


if __name__ == "__main__":
    main()
