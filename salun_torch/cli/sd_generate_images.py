"""SD image generation from a prompt CSV: counterpart of
``salun/cli/sd_generate_images.py`` (reference
SD/eval-scripts/generate-images.py:16-270).

Each ``case_number,prompt,evaluation_seed`` row gets ``--num_samples``
images, sampled with classifier-free guidance and DDIM from latents drawn
by a generator seeded with the row's ``evaluation_seed`` (torch's stream,
not JAX's), decoded, and written as ``save_path/{case}_{i}.png`` (the
flat layout the eval scripts parse) with the standard-library PNG writer.
``--dp N`` under ``torchrun --nproc_per_node N`` groups prompt rows until
the sample batch divides N, each row keeping its own ``evaluation_seed``
latents, and runs each group's chain on N ranks, one shard each; rank 0
writes the files of the single-process run.

Usage:
  python -m salun_torch.cli.sd_generate_images \
      --prompts_path prompts/imagenette.csv --config \
      configs/sd/v1-inference.yaml --ckpt_path unlearned/compvis.ckpt \
      --save_path evaluation_folder --num_samples 10 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from math import gcd

import numpy as np
import torch

from salun_torch.cli.ddpm_sample import write_png
from salun_torch.cli.sd_train import build_modules
from salun_torch.dist import context as dist_ctx
from salun_torch.sd.data import read_prompts_csv
from salun_torch.utils.device import make_generator, seed_all, set_tf32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SD image generation (PyTorch)")
    p.add_argument("--prompts_path", required=True)
    p.add_argument("--config", default=None,
                   help="v1-inference.yaml-style model config")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--save_path", default="evaluation_folder")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=100)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the random init when no --ckpt_path")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel process count (run under torchrun "
                        "--nproc_per_node N): prompt rows are grouped until "
                        "the sample batch divides dp, each row keeping its "
                        "own evaluation_seed latents, and the DDIM chain "
                        "shards over the ranks")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _main(args, device):
    set_tf32(True)
    seed_all(args.seed)
    sd = build_modules(args, device)
    for part in (sd.unet, sd.vae, sd.clip):
        dist_ctx.place_replicated(part)
    os.makedirs(args.save_path, exist_ok=True)
    latent, n = args.image_size // 8, args.num_samples
    # rows grouped so the combined batch divides dp (10 samples × dp 8 → 4
    # rows of 40); each row keeps its own evaluation_seed latents, so the
    # grouped output is the per-row output (DDIM at eta 0 is deterministic
    # given z; the U-Net has no cross-batch operation)
    dp = args.dp if args.dp > 1 else 1
    rows_per_call = dp // gcd(n, dp)
    stats = {"images": 0, "finite": True, "min": float("inf"),
             "max": float("-inf")}
    t0 = time.perf_counter()

    def flush(group):
        gens = [make_generator(int(row.get("evaluation_seed") or 42), device)
                for row in group]
        z = torch.cat([sd.initial_latents(n, latent, g) for g in gens])
        imgs = sd.sample([str(row["prompt"]) for row in group
                          for _ in range(n)],
                         guidance=args.guidance_scale,
                         steps=args.ddim_steps, image_size=latent,
                         initial_latents=z, generator=gens[0])
        stats["images"] += len(imgs)
        stats["finite"] &= bool(torch.isfinite(imgs).all())
        stats["min"] = min(stats["min"], float(imgs.min()))
        stats["max"] = max(stats["max"], float(imgs.max()))
        arr = imgs.permute(0, 2, 3, 1).cpu().numpy()
        for r, row in enumerate(group):
            case = int(row["case_number"])
            if dist_ctx.is_writer():
                for i in range(n):
                    write_png(os.path.join(args.save_path, f"{case}_{i}.png"),
                              (arr[r * n + i] * 255).astype(np.uint8))
            print(f"case {case}: {n} images → {args.save_path}")

    group = []
    for row in read_prompts_csv(args.prompts_path):
        if int(row["case_number"]) < args.from_case:
            continue
        group.append(row)
        if len(group) == rows_per_call:
            flush(group)
            group = []
    if group:
        flush(group)
    dist_ctx.barrier()
    stats["seconds"] = time.perf_counter() - t0
    return stats


if __name__ == "__main__":
    main()
