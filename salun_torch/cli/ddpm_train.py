"""DDPM training and unlearning driver (counterpart of
``salun/cli/ddpm_train.py``; reference DDPM/train.py:132-159).

Modes:

- ``train``: the conditional eps loss with cond-drop, clip → Adam, EMA
  (diffusion.py:194-270); ``retrain`` the same without the forgotten
  class;
- ``forget``: the Selective-Amnesia baseline (diffusion.py:273-396): the
  FIM ``ddpm_fim`` wrote as ``<ckpt_folder>/fisher.pt`` and the class
  samples ``ddpm_sample`` wrote under ``<ckpt_folder>/class_samples``;
- ``saliency_unlearn`` (``--method rl|ga``, ``--mask_path`` to a ``.pt``
  mask): remain + forget loss, clip → grad mask → Adam
  (diffusion.py:482-619);
- ``generate_mask``: saliency of the CFG-scaled eps loss over the forget
  class (diffusion.py:933-1039), written as
  ``save_dir/mask/<label>/with_0.5.pt`` in the reference format.

``train_esd`` raises, as in JAX. Weights come from
``--ckpt_folder``/``ckpts/ckpt.pth`` (a reference checkpoint) or, without
it, from a U-Net seeded with ``--seed``. The trained state goes to
``save_dir/ckpts/ckpt.pth`` (``[model_sd, optim_sd, step, (ema_sd)]``)
every ``snapshot_freq`` steps and at the end. ``--resume`` continues from
that file: model, Adam state, step and EMA, with the data streams moved on
by ``step`` batches. Step s draws from a generator seeded with (``--seed``,
s), so a resumed run draws what a straight one does. ``--dp N`` under
``torchrun --nproc_per_node N`` shards each batch over N ranks
(``salun_torch.dist.context``); rank 0 writes.

Usage:
  python -m salun_torch.cli.ddpm_train --config configs/ddpm/cifar10_train.yml \
      --mode train --data data/ --save_dir base/ [--resume] [--device cpu]
  python -m salun_torch.cli.ddpm_train \
      --config configs/ddpm/cifar10_saliency_unlearn.yml \
      --mode generate_mask --label_to_forget 0 --ckpt_folder base/ \
      --save_dir out/
  python -m salun_torch.cli.ddpm_train \
      --config configs/ddpm/cifar10_saliency_unlearn.yml \
      --mode saliency_unlearn --method rl --label_to_forget 0 \
      --mask_path out/mask/0/with_0.5.pt --ckpt_folder base/ \
      --save_dir unlearned/
  python -m salun_torch.cli.ddpm_train --config configs/ddpm/cifar10_forget.yml \
      --mode forget --label_to_forget 0 --ckpt_folder base/ --save_dir sa/
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from salun_torch.ckpt import (load_ddpm_states, load_ddpm_train_state,
                              load_mask, save_ddpm_states, save_mask)
from salun_torch.cli.ddpm_config import load_config
from salun_torch.data import ddpm_data
from salun_torch.data.loader import BatchIterator
from salun_torch.diffusion import ConditionalUNet
from salun_torch.diffusion.runner import DDPMRunner, make_optimizer
from salun_torch.dist import context as dist_ctx
from salun_torch.utils.device import make_generator, seed_all, set_tf32


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
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel process count (0/1 = one process; "
                        "N: run under torchrun --nproc_per_node N). The "
                        "product-path replacement for the reference's "
                        "DataParallel wrap of the U-Net "
                        "(DDPM/runners/diffusion.py:203,504,628): state "
                        "replicates, batches shard, gradients all-reduce.")
    p.add_argument("--resume", action="store_true",
                   help="continue from save_dir/ckpts/ckpt.pth: model, "
                        "Adam state, step and EMA")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    return p.parse_args(argv)


def ckpt_path(folder: str) -> str:
    return os.path.join(folder, "ckpts", "ckpt.pth")


def fim_path(folder: str) -> str:
    """Where ``ddpm_fim`` writes the FIM and ``forget`` reads it."""
    return os.path.join(folder, "fisher.pt")


def load_unet(runner: DDPMRunner, args) -> ConditionalUNet:
    """The reference checkpoint under ``--ckpt_folder`` (strict), or a
    U-Net seeded with ``--seed``."""
    if not args.ckpt_folder:
        return runner.init(args.seed)
    model_sd, _, _ = load_ddpm_states(ckpt_path(args.ckpt_folder))
    model = ConditionalUNet(runner.unet_cfg)
    model.load_state_dict(model_sd, strict=True)
    return model.to(runner.device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``: a pure function of (seed, step), as
    JAX's ``fold_in(key, step)``."""
    return make_generator((seed * 1_000_003 + step) % (2**63 - 1), device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _by_name(model, tensors: dict, what: str) -> list:
    """``tensors`` (``{param name: tensor}``) in ``model.parameters()``
    order; every parameter must be there."""
    names = [n for n, _ in model.named_parameters()]
    if set(tensors) != set(names):
        raise KeyError(f"the {what} does not cover the model's parameters: "
                       f"missing {sorted(set(names) - set(tensors))[:5]}, "
                       f"extra {sorted(set(tensors) - set(names))[:5]}")
    return [tensors[n] for n in names]


def _streams(args, cfg, runner, model, optimizer, train_ds, bundle):
    """(step function, batch streams) for the training modes."""
    def stream(ds):
        return ddpm_data.cycle(BatchIterator(ds, cfg.batch_size,
                                             shuffle=True, seed=args.seed))

    if args.mode in ("train", "retrain"):
        ds = train_ds
        if args.mode == "retrain":  # the forgotten class dropped entirely
            ds, _ = ddpm_data.get_forget_dataset(ds, args.label_to_forget)
        return runner.make_train_step(model, optimizer), [stream(ds)]
    if args.mode == "saliency_unlearn":
        remain, forget = ddpm_data.get_forget_dataset(train_ds,
                                                      args.label_to_forget)
        return (runner.make_saliency_unlearn_step(model, optimizer),
                [stream(remain), stream(forget)])
    # forget (SA): the FIM and θ_mle of the model loaded above, the
    # remember set from the generated class samples
    folder = args.ckpt_folder or args.save_dir
    fisher = _by_name(model, load_mask(fim_path(folder), runner.device),
                      "FIM")
    theta_mle = [p.detach().clone() for p in model.parameters()]
    remember = ddpm_data.image_folder_dataset(
        os.path.join(args.ckpt_folder or ".", "class_samples"),
        image_size=bundle.unet.image_size)
    remember = ddpm_data.all_but_one_class_dataset(remember,
                                                   args.label_to_forget)
    return (runner.make_train_forget_step(model, optimizer, fisher,
                                          theta_mle), [stream(remember)])


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "train_esd":
        # the reference dispatches Diffusion.train_esd, which does not
        # exist (DDPM/train.py:147-158)
        raise NotImplementedError(
            "train_esd is dispatched but unimplemented in the reference "
            "(DDPM/train.py:147-158); use mode=saliency_unlearn --method ga.")
    return dist_ctx.run(args.dp, args.device, lambda dev: _main(args, dev))


def _main(args, device):
    logging.basicConfig(level=logging.INFO)
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
    dist_ctx.place_replicated(model)

    if args.mode == "generate_mask":
        _, forget = ddpm_data.get_forget_dataset(train_ds,
                                                 args.label_to_forget)
        loader = BatchIterator(forget, cfg.batch_size, shuffle=True,
                               seed=args.seed)
        t0 = time.perf_counter()
        masks = runner.generate_mask(model, loader, thresholds=(0.5,),
                                     generator=make_generator(args.seed,
                                                              device))
        for t, m in masks.items():
            if dist_ctx.is_writer():
                save_mask(os.path.join(args.save_dir, "mask",
                                       str(args.label_to_forget),
                                       f"with_{t}.pt"), m)
        dist_ctx.barrier()
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
    step_fn, streams = _streams(args, cfg, runner, model, optimizer,
                                train_ds, bundle)

    start = 0
    if args.resume and os.path.exists(ckpt_path(args.save_dir)):
        model_sd, optim_sd, start, ema_sd = load_ddpm_train_state(
            ckpt_path(args.save_dir))
        model.load_state_dict(model_sd, strict=True)
        optimizer.adam.load_state_dict(optim_sd)
        if step_fn.shadow is not None and ema_sd is not None:
            for name, s in step_fn.shadow.items():
                s.copy_(ema_sd[name])
        dist_ctx.place_replicated(model)
        for _ in range(start):  # the data streams where the run stopped
            for it in streams:
                next(it)
        logging.info(f"resumed from {ckpt_path(args.save_dir)} at step "
                     f"{start}")

    losses, labels = [], set()
    t0 = time.perf_counter()
    t_first = None
    for step in range(start, cfg.n_iters):
        batches = [next(it) for it in streams]
        for b in batches:
            labels.update(int(c) for c in set(b["label"].tolist()))
        losses.append(step_fn(*batches, step_generator(args.seed, step,
                                                       device)))
        if step == start:  # the steady-state clock starts after one step
            _sync(device)
            t_first = time.perf_counter()
        if (step + 1) % cfg.log_freq == 0:
            logging.info(f"step {step} loss {float(losses[-1]):.4f} "
                         f"({time.perf_counter() - t0:.1f}s)")
        if (step + 1) % cfg.snapshot_freq == 0:
            _save(args, model, optimizer, step + 1, step_fn.shadow)
    _sync(device)
    t_end = time.perf_counter()
    dist_ctx.check_replicas(model.state_dict().values(), "parameters")
    if cfg.n_iters % cfg.snapshot_freq != 0:
        _save(args, model, optimizer, cfg.n_iters, step_fn.shadow)
    dist_ctx.barrier()
    seconds = {"first_step": (t_first or t_end) - t0,
               "later_steps": t_end - (t_first or t_end)}
    later = max(cfg.n_iters - start - 1, 0)
    ms = 1e3 * seconds["later_steps"] / later if later else float("nan")
    print(f"{args.mode} seconds: first step {seconds['first_step']:.3f}, "
          f"steps {start + 2}-{cfg.n_iters} {seconds['later_steps']:.3f} "
          f"({ms:.3f} ms/step)")
    return {"losses": [float(x) for x in losses], "seconds": seconds,
            "ms_per_step": ms, "start_step": start,
            "labels_seen": sorted(labels)}


def _save(args, model, optimizer, step, shadow=None):
    """The reference's ``[model, optimizer, step, (ema)]`` list
    (diffusion.py:252-265), written by rank 0."""
    if not dist_ctx.is_writer():
        return
    save_ddpm_states(ckpt_path(args.save_dir), model.state_dict(),
                     optimizer.adam.state_dict(), step, shadow)


if __name__ == "__main__":
    main()
