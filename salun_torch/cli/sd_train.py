"""SD SalUn command line: counterpart of ``salun/cli/sd_train.py``.

Ported subcommands:

- ``generate_mask`` (SD/train-scripts/generate_mask.py): the saliency mask
  of the forget class's first ``--num_samples`` images, written as
  ``save_dir/mask/<class>/with_<threshold>.pt`` (``{"model.diffusion_model.
  <name>": uint8 0/1}``, which ``salun.cli.sd_train`` reads too);
- ``random_label`` (random_label.py, SalUn class forgetting) with
  ``--mask_path`` to such a ``.pt``: ``--epochs`` passes over the forget
  class at ``--batch_size``, each step drawing a remain batch (numpy
  ``RandomState(seed)`` permutations, as the JAX loop), then
  ``save_dir/compvis.ckpt`` (``{"state_dict": ...}`` of all three models,
  which ``salun.sd.import_compvis`` reads).

``gradient_ascent``, ``nsfw_removal``, ``proximal`` and ``esd`` raise, as do
``--dp`` > 1, ``--fsdp`` and ``--cache_vae_moments`` (ROADMAP queue 1,
slice D). Weights come from a CompVis ``--ckpt_path`` (``.ckpt``) or,
without one, from a seeded random init. ``--remat`` (or the yaml's
``use_checkpoint``) checkpoints each ResBlock and SpatialTransformer.

Usage:
  python -m salun_torch.cli.sd_train generate_mask \
      --config configs/sd/v1-inference.yaml --ckpt_path sd-v1-4.ckpt \
      --data data/ --class_to_forget 0 --save_dir out/ [--device cpu]
  python -m salun_torch.cli.sd_train random_label \
      --config configs/sd/v1-inference.yaml --ckpt_path sd-v1-4.ckpt \
      --data data/ --class_to_forget 0 --mask_path \
      out/mask/0/with_0.5.pt --save_dir unlearned/ [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from salun_torch.ckpt import (load_compvis_state_dict, load_sd_mask,
                              load_sd_modules, save_compvis, save_sd_mask)
from salun_torch.sd import data as sd_data
from salun_torch.sd.clip_text import CLIPTextConfig, tokenize
from salun_torch.sd.config import (SDYamlConfig, load_sd_config,
                                   modules_from_config)
from salun_torch.sd.trainers import (NOT_PORTED, make_random_label_step,
                                     sd_generate_mask, with_mask)
from salun_torch.sd.unet import SDUNetConfig
from salun_torch.sd.vae import VAEConfig
from salun_torch.utils.device import (make_generator, resolve_device,
                                      seed_all, set_tf32)

PORTED = ("generate_mask", "random_label")


def _common(p):
    p.add_argument("--config", type=str, default=None,
                   help="v1-inference.yaml-style model config; default: "
                        "the sd-v1 dataclass defaults")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="CompVis sd-v1 .ckpt")
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--train_method", type=str, default="full")
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_dir", type=str, default="results/sd")
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="block-level gradient checkpointing on the U-Net "
                        "(the reference's use_checkpoint: True)")
    p.add_argument("--cache_vae_moments", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SalUn SD trainers (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)
    gm = sub.add_parser("generate_mask")
    _common(gm)
    gm.add_argument("--class_to_forget", type=int, default=0)
    gm.add_argument("--c_guidance", type=float, default=7.5)
    gm.add_argument("--threshold", type=float, default=0.5)
    gm.add_argument("--num_samples", type=int, default=64)
    for name in ("random_label", "gradient_ascent", "proximal",
                 "nsfw_removal", "esd"):
        q = sub.add_parser(name)
        _common(q)
        q.add_argument("--class_to_forget", type=int, default=0)
        q.add_argument("--epochs", type=int, default=5)
    return p.parse_args(argv)


def build_modules(args, device):
    """The three models from ``--config`` (``--remat`` adds to the yaml's
    use_checkpoint) with the ``--ckpt_path`` weights, or seeded random
    ones."""
    if args.config:
        cfg = load_sd_config(args.config)
    else:
        cfg = SDYamlConfig(SDUNetConfig(), VAEConfig(), CLIPTextConfig())
    remat = cfg.unet.remat or getattr(args, "remat", False)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                            remat=remat))
    sd = modules_from_config(cfg, device, seed=args.seed)
    if args.ckpt_path:
        if not args.ckpt_path.endswith(".ckpt"):
            raise ValueError("the port reads CompVis .ckpt files; orbax "
                             "checkpoints are the JAX package's")
        load_sd_modules(sd, load_compvis_state_dict(args.ckpt_path))
    else:
        print("WARNING: no --ckpt_path, using random init (pipeline check "
              "only)")
    return sd


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    if args.cmd not in PORTED:
        raise NotImplementedError(f"{args.cmd} is not ported yet "
                                  f"({NOT_PORTED})")
    for flag, on in (("--dp", args.dp > 1), ("--fsdp", args.fsdp),
                     ("--cache_vae_moments", args.cache_vae_moments)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet "
                                      f"({NOT_PORTED})")
    device = resolve_device(args.device)
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)
    sd = build_modules(args, device)
    gen = make_generator(args.seed, device)
    ds = sd_data.load_imagenette(args.data, args.image_size)
    forget, remain = sd_data.forget_remain_split(ds, args.class_to_forget)
    if args.cmd == "generate_mask":
        return _generate_mask(args, sd, forget, gen, device)
    return _random_label(args, sd, forget, remain, gen, device)


def _generate_mask(args, sd, forget, gen, device):
    n = min(args.num_samples, len(forget))
    imgs = sd_data.to_pm1(forget.data[:n], device)
    prompts = [sd_data.DESCRIPTIONS[args.class_to_forget]] * n
    t0 = time.perf_counter()
    masks = sd_generate_mask(sd, imgs, prompts, guidance=args.c_guidance,
                             batch_size=args.batch_size,
                             thresholds=(args.threshold,), generator=gen)
    out = os.path.join(args.save_dir, "mask", str(args.class_to_forget))
    for t, m in masks.items():
        save_sd_mask(os.path.join(out, f"with_{t}.pt"), m)
    _sync(device)
    seconds = time.perf_counter() - t0
    print(f"mask generation seconds {seconds:.3f} ({n} images, batches of "
          f"{args.batch_size})")
    return {"masks": masks, "seconds": seconds}


def _random_label(args, sd, forget, remain, gen, device):
    mask = (load_sd_mask(args.mask_path, device) if args.mask_path
            else None)
    optimizer = with_mask(sd.unet, args.lr, args.train_method, mask)
    step = make_random_label_step(sd, optimizer, alpha=args.alpha)
    bs = args.batch_size
    pseudo_cls = (args.class_to_forget + 1) % 10
    descriptions = sd_data.DESCRIPTIONS
    rng = np.random.RandomState(args.seed)
    losses = []
    t0 = time.perf_counter()
    t_first = None
    for epoch in range(args.epochs):
        order_f = rng.permutation(len(forget))
        order_r = rng.permutation(len(remain))
        for i in range(max(len(forget) // bs, 1)):
            fi = order_f[(i * bs) % len(forget):][:bs]
            ri = order_r[(i * bs) % len(remain):][:bs]
            if len(fi) < bs or len(ri) < bs:
                continue
            batch = {
                "forget_images": sd_data.to_pm1(forget.data[fi], device),
                "remain_images": sd_data.to_pm1(remain.data[ri], device),
                "forget_ids": tokenize(
                    [descriptions[c] for c in forget.targets[fi]]),
                "pseudo_ids": tokenize([descriptions[pseudo_cls]] * bs),
                "remain_ids": tokenize(
                    [descriptions[c] for c in remain.targets[ri]]),
            }
            losses.append(step(batch, gen))
            if t_first is None:  # steady-state clock starts after step 1
                _sync(device)
                t_first = time.perf_counter()
        if losses:
            print(f"epoch {epoch} loss {float(losses[-1]):.4f}")
    _sync(device)
    t_end = time.perf_counter()
    later = max(len(losses) - 1, 0)
    ms = (1e3 * (t_end - t_first) / later if later else float("nan"))
    print(f"random_label: {len(losses)} steps, first "
          f"{(t_first or t_end) - t0:.3f} s, then {ms:.3f} ms/step")
    save_compvis(os.path.join(args.save_dir, "compvis.ckpt"), sd)
    return {"losses": [float(x) for x in losses], "ms_per_step": ms,
            "seconds": {"first_step": (t_first or t_end) - t0,
                        "later_steps": t_end - (t_first or t_end)}}


if __name__ == "__main__":
    main()
