"""DDPM sampling driver (counterpart of ``salun/cli/ddpm_sample.py``;
reference DDPM/sample.py and the runner's sample modes,
diffusion.py:642-931).

Modes: ``sample``, ``sample_fid`` and ``sample_classes``
(``--n_samples_per_class`` per class, in batches of ``--batch``),
``sample_one_class`` (one image per class), each written as PNGs
``save_dir/<class>/<i>.png``; ``sample_visualization``, 10 images of every
class, class by class, tiled row-major into ``save_dir/grid.png`` with
``n_classes`` columns; ``sample_trajectory``, the whole chain of
one image per class as ``save_dir/trajectory.npz`` (``xs`` and
``x0_preds`` [steps, B, H, W, C] in [0,1], ``classes``). ``--classes``
takes the ``x0`` exclusion syntax; ``--timesteps``, ``--sample_type
generalized|ddpm_noisy``, ``--eta`` and ``--cond_scale`` as in JAX. PNGs
are written with the standard library. ``--dp N`` under ``torchrun
--nproc_per_node N`` runs each batch's chain on N ranks, one shard each;
the samples come back to every rank and rank 0 writes the files of the
single-process run.

Usage:
  python -m salun_torch.cli.ddpm_sample \
      --config configs/ddpm/cifar10_sample.yml --mode sample_fid \
      --ckpt_folder unlearned/ --classes 0,1 --n_samples_per_class 16 \
      --timesteps 50 --save_dir samples/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib

import numpy as np
import torch

from salun_torch.ckpt import load_ddpm_states
from salun_torch.cli.ddpm_config import load_config
from salun_torch.cli.ddpm_train import ckpt_path
from salun_torch.diffusion import ConditionalUNet
from salun_torch.diffusion.runner import DDPMRunner
from salun_torch.dist import context as dist_ctx
from salun_torch.utils.device import make_generator, seed_all, set_tf32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SalUn DDPM sampling (PyTorch)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--mode", type=str, default="sample_fid",
                   choices=["sample", "sample_fid", "sample_classes",
                            "sample_one_class", "sample_visualization",
                            "sample_trajectory"])
    p.add_argument("--ckpt_folder", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="results/ddpm/samples")
    p.add_argument("--n_samples_per_class", type=int, default=5000)
    p.add_argument("--batch", type=int, default=500)
    p.add_argument("--classes", type=str, default=None,
                   help="'x0' excludes class 0 (functions/__init__.py:126-133)")
    p.add_argument("--cond_scale", type=float, default=2.0)
    p.add_argument("--sample_type", type=str, default="generalized",
                   choices=["generalized", "ddpm_noisy"])
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel process count for sampling (run "
                        "under torchrun --nproc_per_node N): each batch's "
                        "reverse chain shards over N ranks (the reference "
                        "fans sample_fid over 2 GPUs via DataParallel, "
                        "runners/diffusion.py:773-824). Batches are padded "
                        "up to a multiple of dp; pick --batch divisible by "
                        "dp to avoid waste.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    return p.parse_args(argv)


def create_class_labels(spec, n_classes: int) -> list:
    """'x0' exclusion syntax (DDPM/functions/__init__.py:126-133)."""
    if spec is None:
        return list(range(n_classes))
    if spec.startswith("x"):
        excluded = {int(c) for c in spec[1:].split(",")}
        return [c for c in range(n_classes) if c not in excluded]
    return [int(c) for c in spec.split(",")]


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit HxW (gray), HxWx3 (RGB) or HxWx4 (RGBA) image as a PNG,
    with ``zlib`` and ``struct`` only."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows))
                + chunk(b"IEND", b""))


def save_images(imgs: torch.Tensor, out_dir: str, start: int = 0) -> None:
    """NCHW images in [0,1] → ``<start + i>.png``, quantised as the JAX CLI
    does (clip, ×255, truncate)."""
    arr = imgs.detach().cpu().permute(0, 2, 3, 1).numpy()
    for i, img in enumerate(arr):
        write_png(os.path.join(out_dir, f"{start + i}.png"),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_grid(imgs: torch.Tensor, path: str, n_cols: int) -> None:
    """NCHW images in [0,1] tiled row-major into one PNG of ``n_cols``
    columns, quantised as :func:`save_images` does (``_save_grid`` of the
    JAX CLI)."""
    arr = (np.clip(imgs.detach().cpu().permute(0, 2, 3, 1).numpy(), 0, 1)
           * 255).astype(np.uint8)
    n, h, w, c = arr.shape
    rows = (n + n_cols - 1) // n_cols
    grid = np.zeros((rows * h, n_cols * w, c), np.uint8)
    for i, img in enumerate(arr):
        r, col = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    write_png(path, grid)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """[..., C, H, W] → [..., H, W, C] numpy, the JAX files' layout."""
    return x.detach().cpu().movedim(-3, -1).numpy()


def _stats(tensors, n: int, t0: float, path: str) -> dict:
    out = {"images": n, "path": path,
           "finite": all(bool(torch.isfinite(t).all()) for t in tensors),
           "min": min(float(t.min()) for t in tensors),
           "max": max(float(t.max()) for t in tensors),
           "seconds": time.perf_counter() - t0}
    print(f"wrote {path} ({n} images) in {out['seconds']:.3f} s")
    return out


def main(argv=None):
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _main(args, device):
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)

    bundle = load_config(args.config, cond_scale=args.cond_scale)
    runner = DDPMRunner(bundle.unet, bundle.schedule, bundle.train, device)
    model_sd, _, ema_sd = load_ddpm_states(ckpt_path(args.ckpt_folder))
    model = ConditionalUNet(bundle.unet)
    model.load_state_dict(ema_sd if args.use_ema and ema_sd is not None
                          else model_sd, strict=True)
    model = model.to(device)
    dist_ctx.place_replicated(model)
    gen = make_generator(args.seed, device)

    classes = create_class_labels(args.classes, bundle.unet.n_classes)
    t0 = time.perf_counter()
    if args.mode == "sample_trajectory":
        xs, x0s = runner.sample_trajectory(
            model, classes=classes, cond_scale=args.cond_scale,
            sample_type=args.sample_type, timesteps=args.timesteps,
            eta=args.eta, generator=gen)
        out = os.path.join(args.save_dir, "trajectory.npz")
        if dist_ctx.is_writer():
            np.savez_compressed(out, xs=_nhwc(xs), x0_preds=_nhwc(x0s),
                                classes=np.asarray(classes))
        dist_ctx.barrier()
        return _stats([xs, x0s], len(classes), t0, out)
    if args.mode == "sample_visualization":
        imgs = runner.sample_visualization(model, cond_scale=args.cond_scale,
                                           timesteps=args.timesteps,
                                           generator=gen)
        out = os.path.join(args.save_dir, "grid.png")
        if dist_ctx.is_writer():
            save_grid(imgs, out, bundle.unet.n_classes)
        dist_ctx.barrier()
        return _stats([imgs], len(imgs), t0, out)

    per_class = (1 if args.mode == "sample_one_class"
                 else args.n_samples_per_class)
    stats = {"images": 0, "finite": True, "min": float("inf"),
             "max": float("-inf")}
    for c in classes:
        out_dir = os.path.join(args.save_dir, str(c))
        os.makedirs(out_dir, exist_ok=True)
        done = 0
        while done < per_class:
            n = min(args.batch, per_class - done)
            # a --dp mesh shards the chain's batch: a ragged batch is padded
            # up to a multiple of dp and the surplus dropped
            n_run = -(-n // args.dp) * args.dp if args.dp > 1 else n
            imgs = runner.sample_classes(
                model, classes=[c], n_per_class=n_run,
                cond_scale=args.cond_scale, sample_type=args.sample_type,
                timesteps=args.timesteps, eta=args.eta, generator=gen)[:n]
            if dist_ctx.is_writer():
                save_images(imgs, out_dir, start=done)
            stats["images"] += n
            stats["finite"] &= bool(torch.isfinite(imgs).all())
            stats["min"] = min(stats["min"], float(imgs.min()))
            stats["max"] = max(stats["max"], float(imgs.max()))
            done += n
    dist_ctx.barrier()
    stats["seconds"] = time.perf_counter() - t0
    print(f"sampled {stats['images']} images of classes {classes} in "
          f"{stats['seconds']:.3f} s")
    return stats


if __name__ == "__main__":
    main()
