"""DDPM FIM driver (counterpart of ``salun/cli/ddpm_fim.py``; reference
DDPM/fim.py and Diffusion.save_fim, runners/diffusion.py:101-191): the
diagonal Fisher information of the conditional eps loss from per-sample
gradients (``vmap(grad)``), for the Selective-Amnesia ``forget`` mode of
``ddpm_train``. Written as ``save_dir/fisher.pt``, ``{param name: fp32
tensor}`` as masks are.

Usage:
  python -m salun_torch.cli.ddpm_fim --config configs/ddpm/cifar10_fim.yml \
      --data data/ --ckpt_folder base/ --save_dir base/ \
      [--n_samples 512] [--batch 8] [--n_timestep_samples 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from salun_torch.ckpt import save_mask
from salun_torch.cli.ddpm_config import load_config
from salun_torch.cli.ddpm_train import fim_path, load_unet
from salun_torch.data import ddpm_data
from salun_torch.data.loader import BatchIterator
from salun_torch.diffusion.runner import DDPMRunner
from salun_torch.utils.device import (make_generator, resolve_device,
                                      seed_all, set_tf32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SalUn DDPM FIM (PyTorch)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--ckpt_folder", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="results/ddpm")
    p.add_argument("--n_samples", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_timestep_samples", type=int, default=16,
                   help="set to num_diffusion_timesteps for the exact "
                        "reference estimator (all 1000 t per sample)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    bundle = load_config(args.config)
    runner = DDPMRunner(bundle.unet, bundle.schedule, bundle.train, device)
    model = load_unet(runner, args)
    ds = ddpm_data.get_dataset(bundle.dataset, args.data, train=True,
                               image_size=bundle.unet.image_size)
    if args.n_samples:
        ds = ds.select(range(min(args.n_samples, len(ds))))
    loader = BatchIterator(ds, args.batch, shuffle=False, drop_last=True)
    t0 = time.perf_counter()
    fim = runner.compute_fim(model, loader,
                             n_timestep_samples=args.n_timestep_samples,
                             generator=make_generator(args.seed, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    save_mask(fim_path(args.save_dir), fim)
    print(f"FIM seconds {seconds:.3f} ({len(loader)} batches of "
          f"{args.batch}, {args.n_timestep_samples} timesteps each)")
    return {"fim": fim, "seconds": seconds}


if __name__ == "__main__":
    main()
