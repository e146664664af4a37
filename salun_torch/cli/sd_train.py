"""SD concept-erasure command line: counterpart of
``salun/cli/sd_train.py``, one subcommand per SD/train-scripts script:

- ``generate_mask`` (generate_mask.py): the saliency mask of the forget
  class's first ``--num_samples`` images, written as
  ``save_dir/mask/<class>/with_<threshold>.pt`` (``{"model.diffusion_model.
  <name>": uint8 0/1}``, which ``salun.cli.sd_train`` reads too);
- ``random_label`` (random_label.py, SalUn class forgetting),
  ``gradient_ascent`` (gradient_ascent.py) and ``proximal``
  (proximal_gradient.py: random_label, then after each step the global
  shrink toward θ_init by ``--mask_ratio``'s decaying count): ``--epochs``
  passes over the forget class at ``--batch_size``, each step drawing a
  remain batch (numpy ``RandomState(seed)`` permutations, as the JAX loop);
- ``nsfw_removal`` (nsfw_removal.py): random_label over the flat image
  folders ``--forget_dir`` and ``--remain_dir`` with the prompt pair
  nude → wearing clothes;
- ``esd`` (train-esd.py): ``--iterations`` ESD steps over the
  comma-separated ``--prompt`` words, against a frozen copy of the U-Net.

``--mask_path`` (such a ``.pt``) masks the gradients of every training
subcommand. ``--cache_vae_moments`` (random_label, proximal,
nsfw_removal) encodes the forget images' VAE posterior moments and the
prompts' CLIP contexts once instead of every step. Each run writes
``save_dir/compvis.ckpt`` (``{"state_dict": ...}`` of all three models,
which ``salun.sd.import_compvis`` reads). Weights come from a CompVis
``--ckpt_path`` (``.ckpt``) or, without one, from a seeded random init.
``--remat`` (or the yaml's ``use_checkpoint``) checkpoints each ResBlock
and SpatialTransformer. ``--dp N`` under ``torchrun --nproc_per_node N``
shards each batch over N ranks (``salun_torch.dist.context``; rank 0
writes); with it, ``--fsdp`` also shards the U-Net, its Adam moments and
the mask over the N ranks (FSDP2, ``salun_torch.dist.fsdp``; every
training subcommand, not ``generate_mask``); without ``--dp`` it does
nothing.

Usage:
  python -m salun_torch.cli.sd_train generate_mask \
      --config configs/sd/v1-inference.yaml --ckpt_path sd-v1-4.ckpt \
      --data data/ --class_to_forget 0 --save_dir out/ [--device cpu]
  python -m salun_torch.cli.sd_train random_label \
      --config configs/sd/v1-inference.yaml --ckpt_path sd-v1-4.ckpt \
      --data data/ --class_to_forget 0 --mask_path \
      out/mask/0/with_0.5.pt --save_dir unlearned/ [--device cpu]
  python -m salun_torch.cli.sd_train esd --prompt "nudity" \
      --ckpt_path sd-v1-4.ckpt --train_method noxattn --save_dir esd/
  torchrun --standalone --nproc_per_node 2 -m salun_torch.cli.sd_train \
      random_label ... --save_dir unlearned/ --dp 2 --fsdp
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
from salun_torch.dist import context as dist_ctx
from salun_torch.dist import fsdp
from salun_torch.sd import data as sd_data
from salun_torch.sd.clip_text import CLIPTextConfig, tokenize
from salun_torch.sd.config import (SDYamlConfig, load_sd_config,
                                   modules_from_config)
from salun_torch.sd.trainers import (frozen_copy, make_esd_step,
                                     make_gradient_ascent_step,
                                     make_random_label_step, proximal_ratio,
                                     proximal_shrink, sd_generate_mask,
                                     with_mask)
from salun_torch.sd.unet import SDUNetConfig
from salun_torch.sd.vae import VAEConfig
from salun_torch.utils.device import make_generator, seed_all, set_tf32


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
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel process count: run under torchrun "
                        "--nproc_per_node N with --dp N")
    p.add_argument("--fsdp", action="store_true",
                   help="with --dp: shard the U-Net's parameters, Adam "
                        "moments and saliency mask over the data axis "
                        "(ZeRO-3, FSDP2); ignored without --dp")
    p.add_argument("--remat", action="store_true",
                   help="block-level gradient checkpointing on the U-Net "
                        "(the reference's use_checkpoint: True)")
    p.add_argument("--cache_vae_moments", action="store_true",
                   help="encode the forget set's VAE posterior moments and "
                        "the prompts' CLIP contexts once instead of every "
                        "step (random_label, proximal, nsfw_removal)")
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
    for name in ("random_label", "gradient_ascent", "proximal"):
        q = sub.add_parser(name)
        _common(q)
        q.add_argument("--class_to_forget", type=int, default=0)
        q.add_argument("--epochs", type=int, default=5)
        if name == "proximal":
            q.add_argument("--mask_ratio", type=float, default=0.5)
    nz = sub.add_parser("nsfw_removal")
    _common(nz)
    nz.add_argument("--forget_dir", type=str, default="data/nsfw")
    nz.add_argument("--remain_dir", type=str, default="data/not-nsfw")
    nz.add_argument("--epochs", type=int, default=1)
    es = sub.add_parser("esd")
    _common(es)
    es.add_argument("--prompt", type=str, required=True)
    es.add_argument("--iterations", type=int, default=1000)
    es.add_argument("--start_guidance", type=float, default=3.0)
    es.add_argument("--negative_guidance", type=float, default=1.0)
    es.add_argument("--ddim_steps", type=int, default=50)
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


class StepClock:
    """Wall time of the first step apart from the later ones (the card
    synchronised at both ends)."""

    def __init__(self, device):
        self.device = device
        self.t0 = time.perf_counter()
        self.t_first = None
        self.steps = 0

    def tick(self) -> None:
        self.steps += 1
        if self.t_first is None:
            _sync(self.device)
            self.t_first = time.perf_counter()

    def result(self, what: str) -> dict:
        _sync(self.device)
        t_end = time.perf_counter()
        first = (self.t_first or t_end) - self.t0
        later = self.steps - 1
        ms = (1e3 * (t_end - self.t_first) / later if later > 0
              else float("nan"))
        print(f"{what}: {self.steps} steps, first {first:.3f} s, then "
              f"{ms:.3f} ms/step")
        return {"ms_per_step": ms,
                "seconds": {"first_step": first,
                            "later_steps": t_end - (self.t_first or t_end)}}


def main(argv=None):
    args = parse_args(argv)
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _shard_unet(unets, mesh) -> dict:
    """FSDP over the ``data`` axis for each U-Net of ``unets`` (the trainee,
    then ESD's teacher, which runs no backward), one layout for all;
    returns each trainee parameter's local shape."""
    specs = fsdp.fsdp_pspecs(unets[0], mesh)
    for i, unet in enumerate(unets):
        fsdp.shard_fsdp(unet, mesh, specs, reshard_after_forward=i > 0)
    print(f"--fsdp: {fsdp.count_sharded(specs)} of {len(specs)} U-Net "
          f"tensors sharded over {mesh.data} ranks (the rest whole)")
    return {n: list(fsdp.local(p).shape)
            for n, p in unets[0].named_parameters()}


def _main(args, device):
    set_tf32(True)
    os.makedirs(args.save_dir, exist_ok=True)
    seed_all(args.seed)
    sd = build_modules(args, device)
    for part in (sd.unet, sd.vae, sd.clip):
        dist_ctx.place_replicated(part)
    gen = make_generator(args.seed, device)
    if args.cmd == "generate_mask":
        forget, _ = _imagenette_split(args)
        return _generate_mask(args, sd, forget, gen, device)
    mask = (load_sd_mask(args.mask_path, device) if args.mask_path
            else None)
    mesh = dist_ctx.active_mesh()
    sharded = args.fsdp and mesh is not None
    # the teacher is copied before the optimizer takes the U-Net
    teacher = frozen_copy(sd.unet) if args.cmd == "esd" else None
    shapes = (_shard_unet([u for u in (sd.unet, teacher) if u is not None],
                          mesh) if sharded else None)
    optimizer = with_mask(sd.unet, args.lr, args.train_method, mask)
    if args.cmd == "esd":
        result = _esd(args, sd, teacher, optimizer, gen, device)
        del teacher
    elif args.cmd == "nsfw_removal":
        result = _nsfw_removal(args, sd, optimizer, gen, device)
    else:
        result = _forget_class(args, sd, optimizer, gen, device)
    # the writers read the whole U-Net; under FSDP every rank gathers it
    unet_state = fsdp.full_state_dict(sd.unet) if sharded else None
    dist_ctx.check_replicas(unet_state.values() if sharded
                            else sd.unet.parameters(), "U-Net parameters")
    if dist_ctx.is_writer():
        save_compvis(os.path.join(args.save_dir, "compvis.ckpt"), sd,
                     unet_state)
    del unet_state
    dist_ctx.barrier()
    if sharded:
        result["fsdp_local_shapes"] = shapes
    return result


def _imagenette_split(args):
    ds = sd_data.load_imagenette(args.data, args.image_size)
    return sd_data.forget_remain_split(ds, args.class_to_forget)


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
        if dist_ctx.is_writer():
            save_sd_mask(os.path.join(out, f"with_{t}.pt"), m)
    dist_ctx.barrier()
    _sync(device)
    seconds = time.perf_counter() - t0
    print(f"mask generation seconds {seconds:.3f} ({n} images, batches of "
          f"{args.batch_size})")
    return {"masks": masks, "seconds": seconds}


def _use_cache(args) -> bool:
    return args.cache_vae_moments and args.cmd in (
        "random_label", "proximal", "nsfw_removal")


def precompute_forget_moments(sd, images_u8, batch_size: int, device):
    """One VAE pass over the forget images in batches: their posterior
    (mean, logvar), kept on the device (sd_train.py:227-239), and the
    seconds it took."""
    t0 = time.perf_counter()
    means, logvars = [], []
    for i in range(0, len(images_u8), batch_size):
        m, lv = sd.encode_image_moments(
            sd_data.to_pm1(images_u8[i:i + batch_size], device))
        means.append(m)
        logvars.append(lv)
    _sync(device)
    seconds = time.perf_counter() - t0
    print(f"VAE moments of {len(images_u8)} forget images in "
          f"{seconds:.3f} s")
    return (torch.cat(means), torch.cat(logvars)), seconds


def _unet_pinned(params, theta_init) -> int:
    """How many U-Net entries equal θ₀ (under FSDP, summed over the
    ranks' shards, each whole tensor once)."""
    mesh = dist_ctx.active_mesh()
    if mesh is None or not any(fsdp.is_sharded(p) for p in params):
        return int(sum(int((p == t0).sum())
                       for p, t0 in zip(params, theta_init)))
    count = sum(int((a == b).sum()) for a, b in zip(
        fsdp.local_pieces(params, mesh), fsdp.local_pieces(theta_init, mesh)))
    return int(dist_ctx.sum_scalars(count)[0])


def _forget_class(args, sd, optimizer, gen, device):
    """random_label, gradient_ascent and proximal over Imagenette
    (sd_train.py:241-308)."""
    forget, remain = _imagenette_split(args)
    bs = args.batch_size
    pseudo_cls = (args.class_to_forget + 1) % 10
    descriptions = sd_data.DESCRIPTIONS
    use_cache = _use_cache(args)
    out = {}
    if use_cache:
        step = make_random_label_step(sd, optimizer, alpha=args.alpha,
                                      cached="forget")
        (f_mean, f_logvar), out["cache_seconds"] = precompute_forget_moments(
            sd, forget.data, bs, device)
        ctx_table = sd.encode_text(tokenize(list(descriptions)))
    elif args.cmd == "gradient_ascent":
        step = make_gradient_ascent_step(sd, optimizer, alpha=args.alpha)
    else:
        step = make_random_label_step(sd, optimizer, alpha=args.alpha)
    proximal = args.cmd == "proximal"
    params = list(sd.unet.parameters())
    if proximal:
        theta_init = [p.detach().clone() for p in params]
        out["shrinks"] = []
        # the reference's schedule counts the whole model (frozen VAE and
        # CLIP as zero diffs) and a per-epoch denominator of forget +
        # remain batches (proximal_gradient.py:66-73,144-150)
        n_unet = sum(p.numel() for p in params)
        n_total = n_unet + sum(p.numel() for part in (sd.vae, sd.clip)
                               for p in part.parameters())
        n_frozen = n_total - n_unet
        nr_batches = -(-len(remain) // bs)  # ceil, the DataLoader's len
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    nf_batches = max(len(forget) // bs, 1)
    rng = np.random.RandomState(args.seed)
    losses = []
    clock = StepClock(device)
    for epoch in range(args.epochs):
        order_f = rng.permutation(len(forget))
        order_r = rng.permutation(len(remain))
        for i in range(nf_batches):
            fi = order_f[(i * bs) % len(forget):][:bs]
            ri = order_r[(i * bs) % len(remain):][:bs]
            if len(fi) < bs or len(ri) < bs:
                continue
            f_lab, r_lab = forget.targets[fi], remain.targets[ri]
            batch = {
                "remain_images": sd_data.to_pm1(remain.data[ri], device),
                "remain_ids": tokenize([descriptions[c] for c in r_lab])}
            if use_cache:
                idx = torch.from_numpy(fi).to(device)
                batch.update(
                    forget_moments=(f_mean[idx], f_logvar[idx]),
                    forget_ctx=ctx_table[torch.from_numpy(f_lab).to(device)],
                    pseudo_ctx=ctx_table[torch.full((len(fi),), pseudo_cls,
                                                    device=device)])
            else:
                batch.update(
                    forget_images=sd_data.to_pm1(forget.data[fi], device),
                    forget_ids=tokenize([descriptions[c] for c in f_lab]),
                    pseudo_ids=tokenize([descriptions[pseudo_cls]] * bs))
            losses.append(step(batch, gen))
            if proximal:
                ratio = proximal_ratio(args.mask_ratio, epoch, i, nf_batches,
                                       nr_batches, args.epochs,
                                       n_total) - n_frozen
                if ratio >= 1:
                    tau = proximal_shrink(params, theta_init, ratio)
                    out["shrinks"].append({
                        "ratio": ratio, "tau": float(tau),
                        "pinned": _unet_pinned(params, theta_init)})
                    print("proximal shrink: ratio {ratio} tau {tau!r} "
                          "pinned {pinned}".format(**out["shrinks"][-1]))
            clock.tick()
        if losses:
            print(f"epoch {epoch} loss {float(losses[-1]):.4f}")
    out.update(clock.result(args.cmd))
    if proximal:
        out["n_total"], out["n_frozen"] = n_total, n_frozen
        if device.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            print(f"proximal peak memory {out['peak_bytes'] / 2**30:.3f} "
                  f"GiB")
        del theta_init
    out["losses"] = [float(x) for x in losses]
    return out


def _nsfw_removal(args, sd, optimizer, gen, device):
    """random_label over the NSFW / not-NSFW folders with the prompt pair
    nude → wearing clothes (sd_train.py:309-349)."""
    forget = sd_data.load_image_folder(args.forget_dir, args.image_size)
    remain = sd_data.load_image_folder(args.remain_dir, args.image_size)
    bs = args.batch_size
    use_cache = _use_cache(args)
    step = make_random_label_step(sd, optimizer, alpha=args.alpha,
                                  cached="forget" if use_cache else False)
    ids_nude = tokenize([sd_data.WORD_NUDE] * bs)
    ids_wear = tokenize([sd_data.WORD_WEAR] * bs)
    out = {}
    if use_cache:
        (f_mean, f_logvar), out["cache_seconds"] = precompute_forget_moments(
            sd, forget.data, bs, device)
        ctx_nude, ctx_wear = sd.encode_text(ids_nude), sd.encode_text(
            ids_wear)
    rng = np.random.RandomState(args.seed)
    losses = []
    clock = StepClock(device)
    for epoch in range(args.epochs):
        order_f = rng.permutation(len(forget))
        order_r = rng.permutation(len(remain))
        for i in range(len(forget) // bs):
            fi = order_f[i * bs:][:bs]
            ri = order_r[(i * bs) % len(remain):][:bs]
            if len(ri) < bs:
                continue
            batch = {"remain_images": sd_data.to_pm1(remain.data[ri],
                                                     device),
                     "remain_ids": ids_wear}
            if use_cache:
                idx = torch.from_numpy(fi).to(device)
                batch.update(forget_moments=(f_mean[idx], f_logvar[idx]),
                             forget_ctx=ctx_nude[:len(fi)],
                             pseudo_ctx=ctx_wear[:len(fi)])
            else:
                batch.update(
                    forget_images=sd_data.to_pm1(forget.data[fi], device),
                    forget_ids=ids_nude, pseudo_ids=ids_wear)
            losses.append(step(batch, gen))
            clock.tick()
        if losses:
            print(f"epoch {epoch} loss {float(losses[-1]):.4f}")
    out.update(clock.result(args.cmd))
    out["losses"] = [float(x) for x in losses]
    return out


def _esd(args, sd, teacher, optimizer, gen, device):
    """``--iterations`` ESD steps, the prompt words in turn
    (sd_train.py:350-364)."""
    words = [w.strip() for w in args.prompt.split(",")] or [args.prompt]
    step = make_esd_step(sd, optimizer, teacher,
                         negative_guidance=args.negative_guidance,
                         start_guidance=args.start_guidance,
                         ddim_steps=args.ddim_steps,
                         image_size=args.image_size // 8)
    ctx_0 = sd.encode_text(tokenize([""]))
    losses, t_encs = [], []
    clock = StepClock(device)
    for i in range(args.iterations):
        ctx_p = sd.encode_text(tokenize([words[i % len(words)]]))
        loss, t_enc = step(ctx_p, ctx_0, ctx_p, gen)
        losses.append(loss)
        t_encs.append(t_enc)
        clock.tick()
        if (i + 1) % 100 == 0:
            print(f"iter {i} loss {float(losses[-1]):.5f}")
    out = clock.result("esd")
    out["losses"] = [float(x) for x in losses]
    out["t_enc"] = t_encs
    return out


if __name__ == "__main__":
    main()
