"""Saliency-mask generation driver (counterpart of
``salun/cli/generate_mask.py``; reference Classification/generate_mask.py:
85-202).

Loads the pretrained model, sums the gradients of −CE over the
(augmented) forget set in eval mode, and writes ``with_{t}.pt`` masks for
thresholds 0.1…1.0 in the reference format. ``--dp N`` under ``torchrun
--nproc_per_node N``: each rank sums the gradients of its rows of every
batch, the sums are added over the ranks once, and rank 0 writes.

Usage: python -m salun_torch.cli.generate_mask --dataset cifar10 \
           --model_path model.pt --save_dir masks/ [--device cpu]
"""

from __future__ import annotations

import os
import time

import torch

from salun_torch.ckpt import save_mask
from salun_torch.ckpt.store import mask_path
from salun_torch.cli.args import parse_args
from salun_torch.cli.setup import (build_unlearn_loaders, load_model,
                                   setup_model_dataset)
from salun_torch.core.mask import (DEFAULT_THRESHOLDS, accumulate_saliency,
                                   generate_masks)
from salun_torch.core.train import cross_entropy, global_denominator
from salun_torch.data.loader import augment, draw_augment, to_device, to_float
from salun_torch.dist import context as dist_ctx
from salun_torch.utils.device import make_generator, seed_all, set_tf32


def save_gradient_ratio(loaders, model, args, device) -> dict:
    """Masks ``{threshold: {torch_name: 0/1 tensor}}``, also written to
    ``args.save_dir`` (by rank 0). The forget loader inherits the train
    transform (crop + flip, dataset.py:24-31), drawn from a generator
    seeded with ``args.seed + 1`` for the global batch; under a ``--dp``
    mesh each rank keeps its rows and divides by the global batch's
    weight, and rank 0 alone takes a batch that does not divide."""
    use_augment = not args.no_aug and not args.imagenet_arch
    gen = make_generator(args.seed + 1, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    model.eval()

    def batches():
        for b in loaders["forget"]:
            batch = to_device(b, device)
            n = batch["image"].shape[0]
            draws = draw_augment(gen, n) if use_augment else None
            if dist_ctx.skips(n):
                continue
            denom = None
            if dist_ctx.rows(n) is not None:
                denom = global_denominator(batch)
                batch, draws = dist_ctx.ingest((batch, draws))
            img = to_float(batch["image"])
            if use_augment:
                img = augment(img, *draws)
            yield img, batch, denom

    def neg_ce(item):
        img, batch, denom = item
        # loss = −CE (generate_mask.py:36)
        return -cross_entropy(model(img), batch["label"], batch["weight"],
                              denom)

    sal = accumulate_saliency(neg_ce, params, batches())
    masks = {}
    for t, per_param in generate_masks(sal, DEFAULT_THRESHOLDS).items():
        masks[t] = dict(zip(names, per_param))
        if dist_ctx.is_writer():
            save_mask(mask_path(args.save_dir, t), masks[t])
    dist_ctx.barrier()
    return masks


def main(argv=None):
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _main(args, device):
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    model, train, val, test, marked = setup_model_dataset(args, device,
                                                          args.seed)
    loaders, forget, retain = build_unlearn_loaders(args, train, val, test,
                                                    marked)
    print(f"number of retain dataset {len(retain)}")
    print(f"number of forget dataset {len(forget)}")
    if args.model_path:
        load_model(model, args.model_path)
    dist_ctx.place_replicated(model)

    t0 = time.perf_counter()
    masks = save_gradient_ratio(loaders, model, args, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"mask generation seconds {time.perf_counter() - t0:.3f}")
    return masks


if __name__ == "__main__":
    main()
