"""DDPM SalUn driver (counterpart of ``salun/cli/ddpm_train.py``; reference
DDPM/train.py:132-159).

Ported modes:

- ``generate_mask``: saliency of the CFG-scaled eps loss over the forget
  class (diffusion.py:933-1039), written as
  ``save_dir/mask/<label>/with_0.5.pt`` in the reference format;
- ``saliency_unlearn`` (``--method rl|ga``, ``--mask_path`` to a ``.pt``
  mask): remain + forget loss, clip → grad mask → Adam
  (diffusion.py:482-619), written as ``save_dir/ckpts/ckpt.pth``
  (``[model_sd, optim_sd, step, (ema_sd)]``).

``train``, ``retrain`` and ``forget`` raise ``NotImplementedError`` until
they are ported; ``train_esd`` raises as in JAX. Weights come from
``--ckpt_folder``/``ckpts/ckpt.pth`` (a reference checkpoint) or, without
it, from a U-Net seeded with ``--seed``.

Usage:
  python -m salun_torch.cli.ddpm_train \
      --config configs/ddpm/cifar10_saliency_unlearn.yml \
      --mode generate_mask --label_to_forget 0 --ckpt_folder base/ \
      --save_dir out/ [--device cpu]
  python -m salun_torch.cli.ddpm_train \
      --config configs/ddpm/cifar10_saliency_unlearn.yml \
      --mode saliency_unlearn --method rl --label_to_forget 0 \
      --mask_path out/mask/0/with_0.5.pt --ckpt_folder base/ \
      --save_dir unlearned/
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from salun_torch.ckpt import (load_ddpm_states, load_mask, save_ddpm_states,
                              save_mask)
from salun_torch.cli.ddpm_config import load_config
from salun_torch.data import ddpm_data
from salun_torch.data.loader import BatchIterator
from salun_torch.diffusion import ConditionalUNet
from salun_torch.diffusion.runner import DDPMRunner, make_optimizer
from salun_torch.utils.device import (make_generator, resolve_device,
                                      seed_all, set_tf32)

NOT_PORTED = {
    "train": "train/retrain",
    "retrain": "train/retrain",
    "forget": "forget (SA) with compute_fim",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SalUn DDPM (PyTorch)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "retrain", "forget", "saliency_unlearn",
                            "generate_mask", "train_esd"])
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--ckpt_folder", type=str, default=None)
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--method", type=str, default=None,
                   choices=[None, "ga", "rl"])
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--cond_scale", type=float, default=None)
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save_dir", type=str, default="results/ddpm")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    return p.parse_args(argv)


def ckpt_path(folder: str) -> str:
    return os.path.join(folder, "ckpts", "ckpt.pth")


def load_unet(runner: DDPMRunner, args) -> ConditionalUNet:
    """The reference checkpoint under ``--ckpt_folder`` (strict), or a
    U-Net seeded with ``--seed``."""
    if not args.ckpt_folder:
        return runner.init(args.seed)
    model_sd, _, _ = load_ddpm_states(ckpt_path(args.ckpt_folder))
    model = ConditionalUNet(runner.unet_cfg)
    model.load_state_dict(model_sd, strict=True)
    return model.to(runner.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "train_esd":
        # the reference dispatches Diffusion.train_esd, which does not
        # exist (DDPM/train.py:147-158)
        raise NotImplementedError(
            "train_esd is dispatched but unimplemented in the reference "
            "(DDPM/train.py:147-158); use mode=saliency_unlearn --method ga.")
    if args.mode in NOT_PORTED:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (ROADMAP queue 1, slice "
            f"C: {NOT_PORTED[args.mode]})")
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    bundle = load_config(args.config, alpha=args.alpha, method=args.method,
                         cond_scale=args.cond_scale, n_iters=args.n_iters)
    bundle.train.label_to_forget = args.label_to_forget
    cfg = bundle.train
    runner = DDPMRunner(bundle.unet, bundle.schedule, cfg, device)
    train_ds = ddpm_data.get_dataset(bundle.dataset, args.data, train=True,
                                     image_size=bundle.unet.image_size)
    model = load_unet(runner, args)
    gen = make_generator(args.seed, device)
    remain, forget = ddpm_data.get_forget_dataset(train_ds,
                                                  args.label_to_forget)

    if args.mode == "generate_mask":
        loader = BatchIterator(forget, cfg.batch_size, shuffle=True,
                               seed=args.seed)
        t0 = time.perf_counter()
        masks = runner.generate_mask(model, loader, thresholds=(0.5,),
                                     generator=gen)
        for t, m in masks.items():
            save_mask(os.path.join(args.save_dir, "mask",
                                   str(args.label_to_forget),
                                   f"with_{t}.pt"), m)
        _sync(device)
        print(f"mask generation seconds {time.perf_counter() - t0:.3f} "
              f"({len(loader)} batches of {cfg.batch_size})")
        return masks

    mask = None
    if args.mask_path:
        if not args.mask_path.endswith((".pt", ".pth")):
            raise ValueError("the port reads reference-format .pt masks")
        mask = load_mask(args.mask_path, device)
    optimizer = make_optimizer(model, cfg, mask)
    remain_it = ddpm_data.cycle(BatchIterator(remain, cfg.batch_size,
                                              shuffle=True, seed=args.seed))
    forget_it = ddpm_data.cycle(BatchIterator(forget, cfg.batch_size,
                                              shuffle=True, seed=args.seed))
    step_fn = runner.make_saliency_unlearn_step(model, optimizer)
    losses = []
    t0 = time.perf_counter()
    t_first = None
    for step in range(cfg.n_iters):
        losses.append(step_fn(next(remain_it), next(forget_it), gen))
        if step == 0:  # the steady-state clock starts after a warm-up step
            _sync(device)
            t_first = time.perf_counter()
        if (step + 1) % cfg.log_freq == 0:
            logging.info(f"step {step} loss {float(losses[-1]):.4f} "
                         f"({time.perf_counter() - t0:.1f}s)")
        if (step + 1) % cfg.snapshot_freq == 0:
            _save(args, model, optimizer, step + 1, step_fn.shadow)
    _sync(device)
    t_end = time.perf_counter()
    if cfg.n_iters % cfg.snapshot_freq != 0:
        _save(args, model, optimizer, cfg.n_iters, step_fn.shadow)
    seconds = {"first_step": (t_first or t_end) - t0,
               "later_steps": t_end - (t_first or t_end)}
    later = max(cfg.n_iters - 1, 0)
    ms = 1e3 * seconds["later_steps"] / later if later else float("nan")
    print(f"saliency_unlearn seconds: first step {seconds['first_step']:.3f}"
          f", steps 2-{cfg.n_iters} {seconds['later_steps']:.3f} "
          f"({ms:.3f} ms/step)")
    return {"losses": [float(x) for x in losses], "seconds": seconds,
            "ms_per_step": ms}


def _save(args, model, optimizer, step, shadow=None):
    """The reference's ``[model, optimizer, step, (ema)]`` list
    (diffusion.py:252-265)."""
    save_ddpm_states(ckpt_path(args.save_dir), model.state_dict(),
                     optimizer.adam.state_dict(), step, shadow)


if __name__ == "__main__":
    main()
