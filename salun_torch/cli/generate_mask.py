"""Saliency-mask generation driver (counterpart of
``salun/cli/generate_mask.py``; reference Classification/generate_mask.py:
85-202).

Loads the pretrained model, sums the gradients of −CE over the
(augmented) forget set in eval mode, and writes ``with_{t}.pt`` masks for
thresholds 0.1…1.0 in the reference format.

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
from salun_torch.core.train import cross_entropy
from salun_torch.data.loader import augment, draw_augment, to_device, to_float
from salun_torch.utils.device import (make_generator, resolve_device,
                                      seed_all, set_tf32)


def save_gradient_ratio(loaders, model, args, device) -> dict:
    """Masks ``{threshold: {torch_name: 0/1 tensor}}``, also written to
    ``args.save_dir``. The forget loader inherits the train transform
    (crop + flip, dataset.py:24-31), drawn from a generator seeded with
    ``args.seed + 1``."""
    use_augment = not args.no_aug and not args.imagenet_arch
    gen = make_generator(args.seed + 1, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    model.eval()

    def batches():
        for b in loaders["forget"]:
            batch = to_device(b, device)
            img = to_float(batch["image"])
            if use_augment:
                img = augment(img, *draw_augment(gen, img.shape[0]))
            yield img, batch

    def neg_ce(item):
        img, batch = item
        # loss = −CE (generate_mask.py:36)
        return -cross_entropy(model(img), batch["label"], batch["weight"])

    sal = accumulate_saliency(neg_ce, params, batches())
    masks = {}
    for t, per_param in generate_masks(sal, DEFAULT_THRESHOLDS).items():
        masks[t] = dict(zip(names, per_param))
        save_mask(mask_path(args.save_dir, t), masks[t])
    return masks


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
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

    t0 = time.perf_counter()
    masks = save_gradient_ratio(loaders, model, args, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"mask generation seconds {time.perf_counter() - t0:.3f}")
    return masks


if __name__ == "__main__":
    main()
