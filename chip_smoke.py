#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``salun_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the script (exit code 1) when it fails:

1. Device: the card's name and power limit (``nvidia-smi``) and the TF32
   settings. No CUDA device → exit 1 before any result is printed.
2. Build: every kernel under ``salun_torch/csrc`` is compiled from the
   checkout's sources (one ``nvcc`` per source, started together).
3. Kernel vs plain (TF32 off): K1 (fused masked SGD) against its plain
   PyTorch version at N = 11,173,962 (ResNet-18 CIFAR, the main path's
   shape), 50%-dense mask, two learning rates: bitwise equal
   (``torch.equal``). K2, K3a and K3b (flash attention forward, dq, dk/dv)
   against their plain versions at the DDPM path's shapes ([B, N, D] =
   [128, 256, 256], [256, 256, 256], [128, 16, 256]) and ragged ones (N =
   77, Nq ≠ Nk, D = 40, 64, 160, 8): max abs and relative error, failing
   above 1e-4·max(1, max|plain|). Times with CUDA events, the bound, the
   plain version's time and, for K2/K3, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` (forward; backward
   through autograd) on the same tensors, as a yardstick only. Saliency
   masks on the card against the CPU's on a heavily tied input: bitwise.
4. Classification main path at full width: synthetic CIFAR-shaped data
   written in the CIFAR-10 file format, a seeded ResNet-18, then the
   port's own entry points ``salun_torch.cli.generate_mask`` (masks at
   0.1…1.0) and ``salun_torch.cli.main_random --unlearn RL`` (lr 0.013,
   bs 256, one epoch) with UA/RA/TA and SVC-MIA. Checks: the 0.5 mask has
   exactly int(N/2) ones; after RL every masked-out weight equals θ₀
   bitwise; K1's launch count equals the optimizer steps; every metric is
   finite.
5. DDPM chain at full width: the model block of
   ``configs/ddpm/cifar10_saliency_unlearn.yml`` (38,632,323 parameters,
   seeded random weights written as a reference ``ckpts/ckpt.pth``), a
   synthetic CIFAR-format set, then ``salun_torch.cli.ddpm_train --mode
   generate_mask``, ``--mode saliency_unlearn --method rl`` and
   ``salun_torch.cli.ddpm_sample --mode sample_classes --classes 0,1``.
   Cuts, printed: 5,000 training images (500 of class 0) instead of
   50,000; 20 unlearning steps instead of 1,000; 16 samples per class at
   50 DDIM steps instead of 1,000. Checks: the 0.5 mask is exact-k; every
   masked-out weight equals θ₀ bitwise after unlearning and some kept
   weight moved; K2/K3a/K3b launch exactly as the path implies (6
   attention sites per U-Net forward); losses finite; samples finite and
   in [0, 1]. Prints the mask-generation seconds, the unlearning ms per
   step over steps 2–20 and the sampling seconds.
6. A ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Scratch files go to ``build/chip_smoke/`` inside the checkout.
"""

from __future__ import annotations

import json
import math
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

N_K1 = 11_173_962          # ResNet-18 (CIFAR stem, 10 classes) parameters
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32, outside the tensor cores

# Main-path data: CIFAR-shaped, cut in count from CIFAR-10's 50,000/10,000
N_TRAIN, N_TEST, N_FORGET = 12_000, 2_000, 1_000
BATCH, LR, EPOCHS = 256, 0.013, 1

# Flash attention: the DDPM path's [B, N, D] (bs 128 unlearning, the CFG-
# doubled bs 256 of mask generation, the 4x4 mid block) and ragged shapes
# (B, Nq, Nk, D)
ATTN_PATH = [(128, 256, 256, 256), (256, 256, 256, 256), (128, 16, 16, 256)]
ATTN_RAGGED = [(3, 77, 77, 64), (2, 100, 77, 40), (4, 33, 65, 160),
               (2, 1, 5, 8)]
ATTN_TOL = 1e-4  # × max(1, max|plain|): fp32 sums in other orders

# DDPM chain: the reference config, cut in count and steps
DDPM_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_saliency_unlearn.yml"
DDPM_SAMPLE_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_sample.yml"
DDPM_PER_CLASS, DDPM_ITERS = 500, 20
DDPM_SAMPLES, DDPM_STEPS, DDPM_CLASSES = 16, 50, (0, 1)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(n_bytes: float, n_ops: float):
    """(ms, "bytes" | "operations"): the larger of the HBM time and the
    fp32 CUDA-core time."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 3


def k1_vs_plain(device) -> dict:
    import torch

    from salun_torch.kernels.masked_update import (
        masked_sgd_update, masked_sgd_update_reference)

    gen = torch.Generator(device=device).manual_seed(0)
    n = N_K1
    p0 = torch.randn(n, generator=gen, device=device)
    b0 = torch.randn(n, generator=gen, device=device)
    g = torch.randn(n, generator=gen, device=device)
    t0 = torch.randn(n, generator=gen, device=device)
    mask = (torch.rand(n, generator=gen, device=device) < 0.5).to(torch.uint8)
    max_err = 0.0
    for lr_value in (0.013, 0.0013):
        lr = torch.full((1,), lr_value, dtype=torch.float32, device=device)
        p, b = p0.clone(), b0.clone()
        masked_sgd_update(p, b, g, mask, t0, lr)
        want_p, want_b = masked_sgd_update_reference(p0, b0, g, mask, t0, lr)
        torch.cuda.synchronize()
        err = max(float((p - want_p).abs().max()),
                  float((b - want_b).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(p, want_p) and torch.equal(b, want_b)):
            fail(f"K1 differs from its plain version at lr={lr_value}: "
                 f"max abs err {err}")
        log(f"K1 vs plain lr={lr_value}: bitwise equal over {n} elements")

    lr = torch.full((1,), 0.013, dtype=torch.float32, device=device)
    p, b = p0.clone(), b0.clone()
    ms = cuda_time_ms(lambda: masked_sgd_update(p, b, g, mask, t0, lr), 200)
    plain_ms = cuda_time_ms(
        lambda: masked_sgd_update_reference(p, b, g, mask, t0, lr), 50)
    # each input read once, each output written once: p, buf, g, θ₀ (fp32),
    # mask (uint8), lr; p and buf written
    n_bytes = n * (4 * 4 + 1) + 4 + n * 2 * 4
    n_ops = 7 * n  # 4 mul, 2 add, 1 sub per element
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    log(f"K1: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({n_bytes} bytes), {n_bytes / ms / 1e6:.1f} GB/s")
    return {"name": "K1 masked_sgd_update", "route": "cuda",
            "source": "salun_torch/csrc/masked_sgd.cu",
            "replaces": "salun/kernels/masked_update.py:27",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def masks_card_vs_cpu(device) -> None:
    """Top-k masks on the card equal the CPU's bitwise, ties included: the
    stable sort decides ties, and its order must not depend on the device."""
    import torch

    from salun_torch.core.mask import generate_masks

    gen = torch.Generator().manual_seed(1)
    shapes = [(512, 256, 3, 3), (512,), (10, 512), (1_000_003,)]
    # a 16-level grid: masses of exact ties across tensors and thresholds
    sal = [torch.randint(0, 16, s, generator=gen).float() / 16 for s in shapes]
    on_cpu = generate_masks(sal)
    on_card = generate_masks([t.to(device) for t in sal])
    for t, masks in on_cpu.items():
        for a, b in zip(masks, on_card[t]):
            if not torch.equal(a, b.cpu()):
                fail(f"masks differ between the card and the CPU at t={t}")
    n = sum(t.numel() for t in sal)
    log(f"masks on the card equal the CPU's bitwise ({n} values, 16-level "
        f"ties, 10 thresholds)")


def _attn_work(name: str, b: int, nq: int, nk: int, d: int):
    """(bytes, operations) of one call: each input read once, each output
    written once; the matrix products the kernel computes (2 flop per
    multiply-add): K2 q·kᵀ and p·v; K3a those two (recomputing p) and ds·k;
    K3b q·kᵀ, do·vᵀ, pᵀ·do and dsᵀ·q."""
    qd, kd, rows = b * nq * d, b * nk * d, b * nq
    if name == "K2":
        return 4 * (qd + 2 * kd + qd + rows), 4 * b * nq * nk * d
    if name == "K3a":
        return 4 * (2 * qd + 2 * kd + 2 * rows + qd), 6 * b * nq * nk * d
    return 4 * (2 * qd + 2 * kd + 2 * rows + 2 * kd), 8 * b * nq * nk * d


def attention_vs_plain(device):
    """K2, K3a and K3b against their plain versions at the path's and the
    ragged shapes; times at the path's shapes. Returns the three kernel
    entries (at the bs-128 training shape) and ``{(name, shape): ms}``."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import flash_attention as fa

    names = {"K2": "K2 flash_attention_fwd", "K3a": "K3a flash_attention_bwd_dq",
             "K3b": "K3b flash_attention_bwd_dkv"}
    max_err = dict.fromkeys(names, 0.0)
    times = {}
    gen = torch.Generator(device=device).manual_seed(2)
    for shape in ATTN_PATH + ATTN_RAGGED:
        b, nq, nk, d = shape
        q, do = (torch.randn(b, nq, d, generator=gen, device=device)
                 for _ in range(2))
        k, v = (torch.randn(b, nk, d, generator=gen, device=device)
                for _ in range(2))
        scale = d ** -0.5
        want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        delta = (do * want_o).sum(-1)
        bwd = (q, k, v, do, want_lse, delta, scale)
        pairs = {"K2": (fa.flash_attention_fwd(q, k, v, scale, True),
                        (want_o, want_lse)),
                 "K3a": ((fa.flash_attention_bwd_dq(*bwd),),
                         (fa.flash_attention_bwd_dq_reference(*bwd),)),
                 "K3b": (fa.flash_attention_bwd_dkv(*bwd),
                         fa.flash_attention_bwd_dkv_reference(*bwd))}
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            for g, w in zip(got, want):
                err = float((g - w).abs().max())
                ref = float(w.abs().max())
                max_err[name] = max(max_err[name], err)
                log(f"{name} {list(shape)}: max abs err {err:.3e}, "
                    f"relative to max|plain| {err / max(ref, 1e-30):.3e}")
                if not err <= ATTN_TOL * max(1.0, ref):
                    fail(f"{name} differs from its plain version at "
                         f"{list(shape)}: max abs err {err}")
        if shape not in ATTN_PATH:
            continue
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        runs = {
            "K2": (lambda: fa.flash_attention_fwd(q, k, v, scale, True),
                   lambda: fa.flash_attention_fwd_reference(q, k, v, scale),
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=scale)),
            "K3a": (lambda: fa.flash_attention_bwd_dq(*bwd),
                    lambda: fa.flash_attention_bwd_dq_reference(*bwd),
                    lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                retain_graph=True)),
            "K3b": (lambda: fa.flash_attention_bwd_dkv(*bwd),
                    lambda: fa.flash_attention_bwd_dkv_reference(*bwd),
                    None)}
        for name, (kernel, plain, library) in runs.items():
            ms = cuda_time_ms(kernel, 20, warmup=3)
            plain_ms = cuda_time_ms(plain, 10, warmup=2)
            lib_ms = (cuda_time_ms(library, 20, warmup=3) if library
                      else times[("K3a", shape)][2])
            n_bytes, n_ops = _attn_work(name, *shape)
            bound_ms, bound_by = _bound(n_bytes, n_ops)
            times[(name, shape)] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
            what = "SDPA backward (dq, dk, dv)" if name != "K2" else "SDPA"
            log(f"{name} {list(shape)}: {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, {what} {lib_ms:.5f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}: {n_ops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.1f} "
                f"MB; {n_ops / ms / 1e9:.2f} TFLOP/s achieved)")
        del out, ql, kl, vl
    sources = {"K2": ":34", "K3a": ":156", "K3b": ":188"}
    entries = []
    for name, full in names.items():
        ms, plain_ms, lib_ms, bound_ms, bound_by = times[(name, ATTN_PATH[0])]
        entries.append({
            "name": full, "route": "cuda",
            "source": "salun_torch/csrc/flash_attention.cu",
            "replaces": "salun/kernels/flash_attention.py" + sources[name],
            "shape": list(ATTN_PATH[0]), "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
    return entries, {key: t[0] for key, t in times.items()}


# ------------------------------------------------------------------ phase 4


def write_cifar10_files(data_dir: Path, train, test=None) -> None:
    """``train`` (and ``test``) in CIFAR-10's python-pickle format: five
    ``data_batch_*`` files and ``test_batch``."""
    base = data_dir / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)

    def dump(name, ds):
        rows = ds.data.transpose(0, 3, 1, 2).reshape(len(ds), -1)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rows, b"labels": ds.targets.tolist()}, f)

    per = len(train) // 5
    for i in range(5):
        dump(f"data_batch_{i + 1}", train.select(slice(i * per, (i + 1) * per)))
    if test is not None:
        dump("test_batch", test)


def main_path(device, kernel_ms: float) -> dict:
    import torch

    from salun_torch.ckpt import load_mask, load_state_dict
    from salun_torch.cli import generate_mask, main_random
    from salun_torch.cli.args import parse_args
    from salun_torch.cli.setup import build_unlearn_loaders, setup_model_dataset
    from salun_torch.data.datasets import synthetic
    from salun_torch.kernels.masked_update import masked_sgd_update
    from salun_torch.models import create_model

    shutil.rmtree(WORK, ignore_errors=True)
    data_dir, out_dir = WORK / "data", WORK / "out"
    write_cifar10_files(data_dir, synthetic(n=N_TRAIN, seed=0),
                        synthetic(n=N_TEST, seed=1))
    model_path = WORK / "resnet18_seed0.pt"
    model = create_model("resnet18", 10, seed=0)
    torch.save({"state_dict": model.state_dict()}, model_path)

    common = ["--dataset", "cifar10", "--data", str(data_dir),
              "--arch", "resnet18", "--model_path", str(model_path),
              "--save_dir", str(out_dir), "--batch_size", str(BATCH),
              "--num_indexes_to_replace", str(N_FORGET),
              "--class_to_replace", "-1", "--device", str(device)]
    rl_args = common + ["--unlearn", "RL",
                        "--mask_path", str(out_dir / "with_0.5.pt"),
                        "--unlearn_lr", str(LR),
                        "--unlearn_epochs", str(EPOCHS)]

    masked_sgd_update.launches = 0
    t0 = time.perf_counter()
    masks = generate_mask.main(common)
    t_mask = time.perf_counter() - t0
    results = main_random.main(rl_args)
    launches = {"K1 masked_sgd_update": masked_sgd_update.launches}
    torch.cuda.synchronize()

    # exact-k 0.5 mask, as written to disk
    mask = load_mask(str(out_dir / "with_0.5.pt"))
    n_params = sum(v.numel() for v in mask.values())
    ones = int(sum(int(v.sum()) for v in mask.values()))
    if n_params != N_K1 or ones != int(n_params * 0.5):
        fail(f"0.5 mask has {ones} ones of {n_params}, want "
             f"{int(N_K1 * 0.5)} of {N_K1}")
    if set(masks) != {0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0}:
        fail(f"mask thresholds {sorted(masks)}")
    log(f"mask 0.5: exactly {ones} of {n_params} ones")

    # masked-out weights pinned to θ₀, bitwise; kept weights moved
    theta0 = load_state_dict(str(model_path))
    after = load_state_dict(str(out_dir / "RL_checkpoint.pt"))
    moved = 0
    for name, m in mask.items():
        out_w, in_w = after[name], theta0[name]
        if not torch.equal(out_w[m == 0], in_w[m == 0]):
            fail(f"{name}: a masked-out weight left θ₀")
        moved += int((out_w[m > 0] != in_w[m > 0]).sum())
    if moved == 0:
        fail("RL moved no kept weight")
    log(f"after RL: every masked-out weight equals θ₀ bitwise; "
        f"{moved} kept weights moved")

    # one K1 launch per optimizer step
    args = parse_args(rl_args)
    _, train, val, test, marked = setup_model_dataset(args, "cpu", 0)
    loaders, forget, retain = build_unlearn_loaders(args, train, val, test,
                                                    marked)
    steps = EPOCHS * (len(loaders["forget"]) + len(loaders["retain"]))
    if launches["K1 masked_sgd_update"] != steps:
        fail(f"K1 launched {launches['K1 masked_sgd_update']} times for "
             f"{steps} optimizer steps")
    log(f"K1 launches {launches['K1 masked_sgd_update']} = optimizer steps")

    mia = results["SVC_MIA_forget_efficacy"]
    values = [results[k] for k in ("retain", "forget", "val", "test", "UA")]
    values += [mia[k] for k in ("correctness", "confidence", "entropy",
                                "m_entropy", "prob")]
    if len(mia) != 5 or not all(math.isfinite(v) for v in values):
        fail(f"non-finite metrics: {results}")
    sec = results["seconds"]
    images = EPOCHS * (len(forget) + len(retain))
    k1_ms = kernel_ms * launches["K1 masked_sgd_update"]
    log(f"UA {results['UA']:.2f} RA {results['retain']:.2f} "
        f"TA {results['test']:.2f} MIA {json.dumps(mia)}")
    log(f"main path seconds: mask generation {t_mask:.3f} (whole CLI call), "
        f"RL {sec['unlearn']:.3f} (cold: {steps} steps, the first step's "
        f"set-up included; {images / sec['unlearn']:.1f} img/s, "
        f"{1e3 * sec['unlearn'] / steps:.3f} ms/step, "
        f"K1 {k1_ms:.3f} ms of it at the phase-3 time), "
        f"UA/RA/TA {sec['accuracy']:.3f}, SVC-MIA {sec['mia']:.3f}")
    return launches


# ------------------------------------------------------------------ phase 5


def ddpm_dataset():
    """5,000 synthetic CIFAR-shaped images, exactly 500 of each class (the
    first 500 of each class of a seeded draw of 6,000)."""
    import numpy as np

    from salun_torch.data.datasets import synthetic

    pool = synthetic(n=6_000, seed=2)
    idx = [np.flatnonzero(pool.targets == c)[:DDPM_PER_CLASS]
           for c in range(10)]
    if min(len(i) for i in idx) < DDPM_PER_CLASS:
        fail("the synthetic pool has fewer than 500 images of a class")
    return pool.select(np.sort(np.concatenate(idx)))


def ddpm_path(device, attn_ms: dict) -> dict:
    """The DDPM SalUn chain through the port's CLIs; returns the K2/K3
    launch counts of the whole chain."""
    import torch

    from salun_torch.ckpt import load_ddpm_states, load_mask, save_ddpm_states
    from salun_torch.cli import ddpm_sample, ddpm_train
    from salun_torch.cli.ddpm_config import load_config
    from salun_torch.diffusion.runner import DDPMRunner
    from salun_torch.diffusion.sampling import timestep_sequence
    from salun_torch.diffusion.unet import attention_sites
    from salun_torch.kernels import flash_attention as fa

    work = WORK / "ddpm"
    shutil.rmtree(work, ignore_errors=True)
    data_dir = work / "data"
    write_cifar10_files(data_dir, ddpm_dataset())
    bundle = load_config(str(DDPM_CONFIG))
    cfg = bundle.train
    model = DDPMRunner(bundle.unet, bundle.schedule, cfg).init(0)
    theta0 = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    save_ddpm_states(str(work / "base" / "ckpts" / "ckpt.pth"), theta0)
    log(f"DDPM U-Net (ch {bundle.unet.ch}, ch_mult {bundle.unet.ch_mult}, "
        f"{bundle.unet.num_res_blocks} res blocks, attention at "
        f"{bundle.unet.attn_resolutions}, dropout {bundle.unet.dropout}): "
        f"{n_params} parameters, seeded random weights")
    log(f"DDPM cuts: {10 * DDPM_PER_CLASS} training images "
        f"({DDPM_PER_CLASS} of class 0) instead of 50,000; mask generation "
        f"over the whole forget class at bs {cfg.batch_size}, cond_scale "
        f"{cfg.cond_scale}; n_iters {DDPM_ITERS} instead of {cfg.n_iters} "
        f"(bs {cfg.batch_size}, lr {cfg.lr}, alpha {cfg.alpha}); "
        f"{DDPM_SAMPLES} samples per class, DDIM eta 0, {DDPM_STEPS} "
        f"timesteps instead of {bundle.schedule.num_timesteps}")

    common = ["--config", str(DDPM_CONFIG), "--data", str(data_dir),
              "--label_to_forget", "0", "--ckpt_folder", str(work / "base"),
              "--device", str(device)]
    kernels = {"K2 flash_attention_fwd": fa.flash_attention_fwd,
               "K3a flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
               "K3b flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}

    def counts():
        return [f.launches for f in kernels.values()]

    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    ddpm_train.main(common + ["--mode", "generate_mask",
                              "--save_dir", str(work / "mask")])
    t_mask = time.perf_counter() - t0
    after_mask = counts()
    mask_file = work / "mask" / "mask" / "0" / "with_0.5.pt"
    result = ddpm_train.main(common + [
        "--mode", "saliency_unlearn", "--method", "rl",
        "--mask_path", str(mask_file), "--n_iters", str(DDPM_ITERS),
        "--save_dir", str(work / "unlearned")])
    after_unlearn = counts()
    stats = ddpm_sample.main([
        "--config", str(DDPM_SAMPLE_CONFIG), "--mode", "sample_classes",
        "--ckpt_folder", str(work / "unlearned"),
        "--classes", ",".join(map(str, DDPM_CLASSES)),
        "--n_samples_per_class", str(DDPM_SAMPLES),
        "--batch", str(DDPM_SAMPLES), "--timesteps", str(DDPM_STEPS),
        "--sample_type", "generalized", "--eta", "0",
        "--save_dir", str(work / "samples"), "--device", str(device)])
    torch.cuda.synchronize()
    total = counts()
    launches = dict(zip(kernels, total))

    # exact-k 0.5 mask
    mask = load_mask(str(mask_file))
    n_mask = sum(v.numel() for v in mask.values())
    ones = int(sum(int(v.sum()) for v in mask.values()))
    if n_mask != n_params or ones != n_params // 2:
        fail(f"DDPM 0.5 mask has {ones} ones of {n_mask}, want "
             f"{n_params // 2} of {n_params}")
    log(f"DDPM mask 0.5: exactly {ones} of {n_params} ones")

    # masked-out weights pinned to θ₀ bitwise; kept weights moved
    after, step, _ = load_ddpm_states(str(work / "unlearned" / "ckpts" /
                                          "ckpt.pth"))
    moved = 0
    for name, m in mask.items():
        if not torch.equal(after[name][m == 0], theta0[name][m == 0]):
            fail(f"DDPM {name}: a masked-out weight left θ₀")
        moved += int((after[name][m > 0] != theta0[name][m > 0]).sum())
    if moved == 0 or step != DDPM_ITERS:
        fail(f"unlearning moved {moved} kept weights in {step} steps")
    log(f"after {step} rl steps: every masked-out weight equals θ₀ "
        f"bitwise; {moved} kept weights moved")

    # launches as the path implies: per U-Net forward one K2 per site;
    # per backward one K3a and one K3b per site
    sites = attention_sites(bundle.unet)
    n_batches = -(-DDPM_PER_CLASS // cfg.batch_size)
    n_steps = len(timestep_sequence(bundle.schedule.num_timesteps,
                                    DDPM_STEPS))
    want = {"mask": [sites * n_batches] * 3,
            "unlearn": [3 * sites * DDPM_ITERS, 2 * sites * DDPM_ITERS,
                        2 * sites * DDPM_ITERS],
            "sample": [sites * n_steps * len(DDPM_CLASSES), 0, 0]}
    got = {"mask": after_mask,
           "unlearn": [a - b for a, b in zip(after_unlearn, after_mask)],
           "sample": [a - b for a, b in zip(total, after_unlearn)]}
    if got != want:
        fail(f"K2/K3a/K3b launches {got}, the path implies {want}")
    log(f"K2/K3a/K3b launches as the path implies ({sites} attention "
        f"sites per forward): mask generation {got['mask']} "
        f"({n_batches} batches), unlearning {got['unlearn']} "
        f"({DDPM_ITERS} steps), sampling {got['sample']} "
        f"({n_steps} steps x {len(DDPM_CLASSES)} classes)")

    losses = result["losses"]
    if len(losses) != DDPM_ITERS or not all(map(math.isfinite, losses)):
        fail(f"unlearning losses {losses}")
    if not (stats["finite"] and 0.0 <= stats["min"] <= stats["max"] <= 1.0
            and stats["images"] == DDPM_SAMPLES * len(DDPM_CLASSES)):
        fail(f"samples {stats}")
    log(f"unlearning losses finite: first {losses[0]:.4f}, last "
        f"{losses[-1]:.4f}; {stats['images']} samples finite in "
        f"[{stats['min']:.4f}, {stats['max']:.4f}]")

    # the unlearning step's attention time, from the launches and the
    # phase-3 kernel times at bs 128: 3 forwards (5 sites at N = 256, one
    # at N = 16) and 2 backwards per step
    big, mid = ATTN_PATH[0], ATTN_PATH[2]
    big_n, mid_n = sites - 1, 1
    fwd = big_n * attn_ms[("K2", big)] + mid_n * attn_ms[("K2", mid)]
    bwd = sum(big_n * attn_ms[(k, big)] + mid_n * attn_ms[(k, mid)]
              for k in ("K3a", "K3b"))
    step_ms = result["ms_per_step"]
    log(f"DDPM seconds: mask generation {t_mask:.3f} (whole CLI call), "
        f"unlearning {step_ms:.3f} ms/step over steps 2-{DDPM_ITERS} "
        f"(synchronised after a warm-up step; first step "
        f"{result['seconds']['first_step']:.3f} s), sampling "
        f"{stats['seconds']:.3f} s ({stats['images']} images, "
        f"{DDPM_STEPS} steps)")
    log(f"unlearning step: K2 {3 * fwd:.3f} ms + K3a/K3b {2 * bwd:.3f} ms "
        f"= {3 * fwd + 2 * bwd:.3f} ms of {step_ms:.3f} ms "
        f"({100 * (3 * fwd + 2 * bwd) / step_ms:.1f}%) at the phase-3 times")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    try:
        from salun_torch.kernels import _build
        from salun_torch.utils.device import set_tf32, tf32_settings
    except ImportError as e:
        fail(f"the salun_torch package is not beside this script: {e}")

    device = torch.device("cuda", 0)
    card = card_name_and_limit()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    set_tf32(False)  # parity checks run in full fp32
    log(f"TF32 for the kernel checks: {tf32_settings()}")
    kernels = [k1_vs_plain(device)]
    attn_entries, attn_ms = attention_vs_plain(device)
    kernels += attn_entries
    masks_card_vs_cpu(device)

    launches = main_path(device, kernels[0]["ms"])  # CLIs: TF32 on
    launches.update(ddpm_path(device, attn_ms))
    log(f"TF32 on the main paths: {tf32_settings()}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
