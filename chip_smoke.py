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
   above 1e-4·max(1, max|plain|); K2 launched twice at [128, 256, 256,
   256], [32, 1024, 1024, 80] and [4, 4096, 4096, 512] gives bitwise equal
   o and lse, K3a launched twice at [128, 256, 256, 256], [32, 4096, 4096,
   40] and [128, 16, 16, 256] bitwise equal dq, K3b launched twice at
   [128, 256, 256, 256], [32, 4096, 4096, 40] and [32, 4096, 77, 40] (a
   split query walk) bitwise equal dk and dv; K3b's split count is logged
   at every shape. All three multiply on the tensor cores in 3xTF32. Times
   with CUDA events, the bound (the operations at the 3xTF32 tensor-core
   roof, 495/3 TFLOP/s, with the fp32 CUDA-core bound beside it), the
   plain version's time and, for K2/K3, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` (forward; backward
   through autograd) on the same tensors, as a yardstick only. K4 and K4b
   (fused GroupNorm + SiLU forward and backward, one cluster launch each)
   against their plain versions at the SD path's [B, C, H, W] (U-Net [8,
   320, 64, 64], [4, 640, 64, 64], [4, 2560, 8, 8], [4, 320, 64, 64], [4,
   960, 64, 64], [4, 1920, 32, 32] at eps 1e-5; VAE [4, 128, 512, 512]
   and [4, 256, 512, 512] at eps 1e-6) and ragged ones, failing above
   1e-5 (forward) and 1e-4 (backward) × max(1, max|plain|) and unless two
   launches give bitwise equal outputs; times, the bytes bound, achieved
   GB/s, the plan's path and cluster and, as the yardstick,
   ``F.group_norm`` then ``F.silu`` (two calls; their autograd backward
   for K4b). K2 at the SD U-Net's
   self- and cross-attention shapes ([32, N, N or 77, D] for N = 4096,
   1024, 256, 64 and D = 40, 80, 160, 160) with K3a/K3b there, and K2 at
   the VAE's D = 512 ([4, 4096, 4096, 512]). Saliency masks on the card
   against the CPU's on a heavily tied input: bitwise.
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
6. SD chain at full width: ``configs/sd/v1-inference.yaml`` (U-Net
   859,520,964, VAE 83,653,863, CLIP text 123,060,480 parameters) with
   seeded random weights written as a CompVis ``.ckpt`` (no layer at zero,
   norm affines moved off (1, 0)), a synthetic ``imagenette2/train``
   folder of non-square PNGs (10 classes × 16) and the repository's
   synthetic BPE merges, then ``salun_torch.cli.sd_train generate_mask``
   (16 forget images, bs 4, threshold 0.5), ``random_label --remat`` (2
   epochs = 8 steps at bs 4, lr 1e-5, α 0.5, full) and
   ``salun_torch.cli.sd_generate_images`` (2 prompt rows of
   ``prompts/imagenette.csv`` × 2 samples, 50 DDIM steps, guidance 7.5,
   512×512). Checks: the mask is exact-k; every masked-out U-Net weight
   equals θ₀ bitwise and the VAE and CLIP are unchanged bitwise; K2, K3a,
   K3b, K4 and K4b launch exactly as the path implies (remat recompute
   included); losses finite; images in [0, 1], every PNG written. Prints
   the mask-generation seconds, ms per random_label step over steps 2–8
   (and the attention kernels' share of it at the phase-3 times) and the
   sampling seconds with K2's share of a sampling row; then K4's and K4b's
   share of the step and of a sampling row: both kernels and the library
   pair timed at every GroupNormSiLU shape of a seeded full-width U-Net
   and VAE (forward hooks), times their launches.
7. A ``{"kernels": [...]}`` line (launches per path and in all), the
   card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.

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
TF32X3_FLOPS = 495e12 / 3  # H100 SXM TF32 dense, three products (3xTF32)

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
# K2 launched twice must give the same o and lse, bitwise (no atomics)
K2_BITWISE = [(128, 256, 256, 256), (32, 1024, 1024, 80),
              (4, 4096, 4096, 512)]
# K3a the same for dq
K3A_BITWISE = [(128, 256, 256, 256), (32, 4096, 4096, 40),
               (128, 16, 16, 256)]
# K3b the same for dk and dv; [32, 4096, 77, 40] takes the split walk
K3B_BITWISE = [(128, 256, 256, 256), (32, 4096, 4096, 40),
               (32, 4096, 77, 40)]

# DDPM chain: the reference config, cut in count and steps
DDPM_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_saliency_unlearn.yml"
DDPM_SAMPLE_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_sample.yml"
DDPM_PER_CLASS, DDPM_ITERS = 500, 20
DDPM_SAMPLES, DDPM_STEPS, DDPM_CLASSES = 16, 50, (0, 1)

# K4/K4b: the SD path's [B, C, H, W] (the U-Net's level 0 at the CFG-
# doubled bs 4 of mask generation, the 640-channel concat of
# output_blocks.10-11 and the bottom at bs 4, random_label's own bs-4
# level 0, the 960-channel concat of output_blocks.9 (the largest slab the
# kernels keep in a cluster's shared memory) and output_blocks.6's 1920
# channels at 32x32, the VAE's two largest planes at bs 4) and ragged ones,
# each with (groups, eps)
GN_PATH = [((8, 320, 64, 64), 32, 1e-5), ((4, 640, 64, 64), 32, 1e-5),
           ((4, 2560, 8, 8), 32, 1e-5), ((4, 320, 64, 64), 32, 1e-5),
           ((4, 960, 64, 64), 32, 1e-5), ((4, 1920, 32, 32), 32, 1e-5),
           ((4, 128, 512, 512), 32, 1e-6), ((4, 256, 512, 512), 32, 1e-6)]
GN_RAGGED = [((3, 6, 5, 7), 3, 1e-5), ((2, 32, 50, 100), 32, 1e-5),
             ((2, 32, 1, 1), 32, 1e-6)]
GN_TOL = (1e-5, 1e-4)  # forward, backward: × max(1, max|plain|)

# Flash attention at the SD path's [B·heads, Nq, Nk, D]: U-Net self- and
# cross-attention (Nk = 77) at bs 4 (8 heads; random_label's and
# sampling's batch), the VAE's mid-block attention (one head, D = 512) at
# bs 4
ATTN_SD_UNET = [(32, 4096, 4096, 40), (32, 4096, 77, 40),
                (32, 1024, 1024, 80), (32, 1024, 77, 80),
                (32, 256, 256, 160), (32, 256, 77, 160), (32, 64, 64, 160),
                (32, 64, 77, 160)]
ATTN_SD_VAE = [(4, 4096, 4096, 512)]

# SD chain: configs/sd/v1-inference.yaml at full width, seeded weights;
# cut in count (16 forget images instead of 64, 2 epochs instead of 5,
# 2 prompt rows × 2 samples at 50 DDIM steps instead of 100)
SD_CONFIG = ROOT / "configs" / "sd" / "v1-inference.yaml"
SD_PROMPTS = ROOT / "prompts" / "imagenette.csv"
SD_MERGES = ROOT / "tests" / "_synthetic_clip_merges.txt"
SD_IMAGE, SD_PER_CLASS, SD_BS = 512, 16, 4
SD_EPOCHS, SD_LR, SD_ALPHA = 2, 1e-5, 0.5
SD_ROWS, SD_SAMPLES, SD_STEPS, SD_GUIDANCE = 2, 2, 50, 7.5


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


def adaptive_ms(fn, budget_ms: float = 150.0) -> float:
    """``cuda_time_ms`` with as many launches as fit ``budget_ms`` (3 to
    50), after one warm-up launch timed alone."""
    first = cuda_time_ms(fn, 1, warmup=1)
    iters = int(min(50, max(3, budget_ms / max(first, 1e-3))))
    return cuda_time_ms(fn, iters, warmup=1)


def _bound(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS):
    """(ms, "bytes" | "operations"): the larger of the HBM time and the
    time of ``n_ops`` at ``flops`` (by default the fp32 CUDA cores')."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops
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


def _attn_bound(name: str, shape):
    """(bytes, operations, bound ms, bound_by, roof, CUDA-core bound ms):
    K2, K3a and K3b multiply on the tensor cores in 3xTF32."""
    n_bytes, n_ops = _attn_work(name, *shape)
    fp32_ms, _ = _bound(n_bytes, n_ops)
    bound_ms, bound_by = _bound(n_bytes, n_ops, TF32X3_FLOPS)
    return n_bytes, n_ops, bound_ms, bound_by, "3xTF32 tensor cores", fp32_ms


def _k2_bitwise(fa, q, k, v, scale, first, shape) -> None:
    """K2 launched again on the same inputs gives ``first`` bit for bit."""
    import torch

    again = fa.flash_attention_fwd(q, k, v, scale, True)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        fail(f"K2 is not bitwise deterministic at {list(shape)}")
    log(f"K2 {list(shape)}: two launches give bitwise equal o and lse")


def _k3a_bitwise(fa, bwd, first, shape) -> None:
    """K3a launched again on the same inputs gives ``first`` bit for bit."""
    import torch

    again = fa.flash_attention_bwd_dq(*bwd)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"K3a is not bitwise deterministic at {list(shape)}")
    log(f"K3a {list(shape)}: two launches give bitwise equal dq")


def _k3b_split(fa, device, shape) -> str:
    """K3b's split plan at ``shape`` on this card, for the log."""
    b, nq, nk, d = shape
    resident = fa.dkv_resident_blocks(device, d)
    splits, rows = fa.dkv_split_plan(b, nq, nk, d, resident)
    return (f"K3b {list(shape)}: S = {splits} split(s) of the query walk "
            f"({rows} rows each; {resident} resident blocks on the card)")


def _k3b_bitwise(fa, bwd, first, shape) -> None:
    """K3b launched again on the same inputs gives ``first`` bit for bit
    (the split walk's partials are summed in a fixed order)."""
    import torch

    again = fa.flash_attention_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        fail(f"K3b is not bitwise deterministic at {list(shape)}")
    log(f"K3b {list(shape)}: two launches give bitwise equal dk and dv")


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
        k2_out = fa.flash_attention_fwd(q, k, v, scale, True)
        pairs = {"K2": (k2_out, (want_o, want_lse)),
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
        if shape in K2_BITWISE:
            _k2_bitwise(fa, q, k, v, scale, k2_out, shape)
        if shape in K3A_BITWISE:
            _k3a_bitwise(fa, bwd, pairs["K3a"][0][0], shape)
        log(_k3b_split(fa, device, shape))
        if shape in K3B_BITWISE:
            _k3b_bitwise(fa, bwd, pairs["K3b"][0], shape)
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
            (n_bytes, n_ops, bound_ms, bound_by, roof,
             fp32_ms) = _attn_bound(name, shape)
            times[(name, shape)] = (ms, plain_ms, lib_ms, bound_ms, bound_by,
                                    roof)
            what = "SDPA backward (dq, dk, dv)" if name != "K2" else "SDPA"
            log(f"{name} {list(shape)}: {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, {what} {lib_ms:.5f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}, {roof}: {n_ops / 1e9:.3f} GFLOP, "
                f"{n_bytes / 1e6:.1f} MB; CUDA-core bound {fp32_ms:.5f} ms; "
                f"{n_ops / ms / 1e9:.2f} TFLOP/s achieved)")
        del out, ql, kl, vl
    sources = {"K2": ":34", "K3a": ":156", "K3b": ":188"}
    entries = []
    for name, full in names.items():
        (ms, plain_ms, lib_ms, bound_ms, bound_by,
         roof) = times[(name, ATTN_PATH[0])]
        entries.append({
            "name": full, "route": "cuda",
            "source": "salun_torch/csrc/flash_attention.cu",
            "replaces": "salun/kernels/flash_attention.py" + sources[name],
            "shape": list(ATTN_PATH[0]), "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roof": roof, "library_ms": lib_ms})
    return entries, {key: t[0] for key, t in times.items()}


def _gn_work(shape, groups, backward: bool):
    """(bytes, operations) of one K4 (or K4b) call: x read and y written
    (K4b: x, dy read, dx written), the per-channel and per-slab vectors
    once; 9 operations per value forward, 21 backward (exp and division
    counted as one each)."""
    b, c = shape[:2]
    n = math.prod(shape)
    vecs = 2 * c + 2 * b * groups
    if backward:
        return 4 * (3 * n + vecs + 2 * c), 21 * n
    return 4 * (2 * n + vecs), 9 * n


def groupnorm_vs_plain(device):
    """K4 and K4b against their plain versions at the SD path's and ragged
    shapes; times, bounds and the two-call library yardstick
    (``F.group_norm`` then ``F.silu``; its autograd backward) at the
    path's shapes. Returns the K4 and K4b entries (at the U-Net's
    [8, 320, 64, 64]) and a list of per-shape rows."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import groupnorm_silu as gn

    max_err = {"K4": 0.0, "K4b": 0.0}
    rows = []
    gen = torch.Generator(device=device).manual_seed(3)
    for shape, groups, eps in GN_PATH + GN_RAGGED:
        c = shape[1]
        x = 2.0 * torch.randn(shape, generator=gen, device=device) + 0.5
        dy = torch.randn(shape, generator=gen, device=device)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=device)
        bias = 0.3 * torch.randn(c, generator=gen, device=device)
        y, mean, rstd = gn.groupnorm_silu(x, w, bias, groups, eps)
        want = gn.groupnorm_silu_reference(x, w, bias, groups, eps)
        grads = gn.groupnorm_silu_backward(dy, x, w, bias, mean, rstd, groups)
        want_g = gn.groupnorm_silu_backward_reference(dy, x, w, bias,
                                                      want[1], want[2],
                                                      groups)
        torch.cuda.synchronize()
        for name, got, ref, tol in (("K4", (y, mean, rstd), want, GN_TOL[0]),
                                    ("K4b", grads, want_g, GN_TOL[1])):
            errs = []
            for g, r in zip(got, ref):
                errs.append(float((g - r).abs().max()))
                if not errs[-1] <= tol * max(1.0, float(r.abs().max())):
                    fail(f"{name} differs from its plain version at "
                         f"{list(shape)}: max abs err {errs[-1]}")
            max_err[name] = max(max_err[name], *errs)
            log(f"{name} {list(shape)} G {groups} eps {eps}: max abs err "
                f"{max(errs):.3e} (y/dx, then mean, rstd or dscale, dbias: "
                f"{', '.join(f'{e:.3e}' for e in errs)})")
        again = (gn.groupnorm_silu(x, w, bias, groups, eps)
                 + gn.groupnorm_silu_backward(dy, x, w, bias, mean, rstd,
                                              groups))
        if not all(torch.equal(a, b) for a, b in zip((y, mean, rstd)
                                                     + grads, again)):
            fail(f"K4/K4b launched twice at {list(shape)} differ")
        del want, want_g, grads, again
        if (shape, groups, eps) not in GN_PATH:
            continue
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, bias))
        lib_out = F.silu(F.group_norm(xl, groups, wl, bl, eps))
        runs = {
            "K4": (lambda: gn.groupnorm_silu(x, w, bias, groups, eps),
                   lambda: gn.groupnorm_silu_reference(x, w, bias, groups,
                                                       eps),
                   lambda: F.silu(F.group_norm(x, groups, w, bias, eps))),
            "K4b": (lambda: gn.groupnorm_silu_backward(dy, x, w, bias, mean,
                                                       rstd, groups),
                    lambda: gn.groupnorm_silu_backward_reference(
                        dy, x, w, bias, mean, rstd, groups),
                    lambda: torch.autograd.grad(lib_out, (xl, wl, bl), dy,
                                                retain_graph=True))}
        for name, (kernel, plain, library) in runs.items():
            ms, plain_ms, lib_ms = (adaptive_ms(kernel), adaptive_ms(plain),
                                    adaptive_ms(library))
            n_bytes, n_ops = _gn_work(shape, groups, name == "K4b")
            bound_ms, bound_by = _bound(n_bytes, n_ops)
            plan = gn._plan(shape[0], c, math.prod(shape[2:]), groups,
                            name == "K4b")
            rows.append({"name": name, "shape": list(shape), "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"{name} {list(shape)}: {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, F.group_norm + F.silu (two calls"
                f"{', autograd backward' if name == 'K4b' else ''}) "
                f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
                f"{n_bytes / 1e6:.1f} MB; {n_bytes / ms / 1e6:.1f} GB/s "
                f"achieved); {plan.path}, cluster {plan.cluster}, "
                f"{plan.smem} B shared a block")
        del lib_out, xl, wl, bl
    torch.cuda.empty_cache()
    log("K4/K4b launched twice give bitwise equal y, mean, rstd, dx, "
        "dscale and dbias at every shape")
    entries = []
    for name, full, line in (("K4", "K4 groupnorm_silu", ":23"),
                             ("K4b", "K4b groupnorm_silu_backward", ":144")):
        row = next(r for r in rows if r["name"] == name)
        entries.append({
            "name": full, "route": "cuda",
            "source": "salun_torch/csrc/groupnorm_silu.cu",
            "replaces": "salun/kernels/groupnorm_silu.py" + line,
            "shape": row["shape"], "max_abs_err": max_err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    return entries, rows


def sd_attention_vs_plain(device):
    """K2 at the U-Net's self- and cross-attention shapes and at D = 512
    (the VAE), K3a/K3b at the U-Net's: errors against the plain versions,
    times against the bound, the plain version and SDPA. Returns the
    per-shape rows."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import flash_attention as fa

    rows = []
    gen = torch.Generator(device=device).manual_seed(4)
    for shape in ATTN_SD_UNET + ATTN_SD_VAE:
        b, nq, nk, d = shape
        q, do = (torch.randn(b, nq, d, generator=gen, device=device)
                 for _ in range(2))
        k, v = (torch.randn(b, nk, d, generator=gen, device=device)
                for _ in range(2))
        scale = d ** -0.5
        want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        delta = (do * want_o).sum(-1)
        bwd = (q, k, v, do, want_lse, delta, scale)
        k2_out = fa.flash_attention_fwd(q, k, v, scale, True)
        pairs = {"K2": (k2_out, (want_o, want_lse))}
        runs = {"K2": (lambda: fa.flash_attention_fwd(q, k, v, scale),
                       lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                                scale),
                       lambda: F.scaled_dot_product_attention(q, k, v,
                                                              scale=scale))}
        if d <= fa.MAX_D_BWD:
            pairs["K3a"] = ((fa.flash_attention_bwd_dq(*bwd),),
                            (fa.flash_attention_bwd_dq_reference(*bwd),))
            pairs["K3b"] = (fa.flash_attention_bwd_dkv(*bwd),
                            fa.flash_attention_bwd_dkv_reference(*bwd))
            ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            sdpa_bwd = (lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                    retain_graph=True))
            runs["K3a"] = (lambda: fa.flash_attention_bwd_dq(*bwd),
                           lambda: fa.flash_attention_bwd_dq_reference(*bwd),
                           sdpa_bwd)
            runs["K3b"] = (lambda: fa.flash_attention_bwd_dkv(*bwd),
                           lambda: fa.flash_attention_bwd_dkv_reference(
                               *bwd), None)
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            for g, w in zip(got, want):
                err = float((g - w).abs().max())
                ref = float(w.abs().max())
                if not err <= ATTN_TOL * max(1.0, ref):
                    fail(f"{name} differs from its plain version at "
                         f"{list(shape)}: max abs err {err}")
                log(f"{name} {list(shape)}: max abs err {err:.3e}, relative "
                    f"to max|plain| {err / max(ref, 1e-30):.3e}")
        if shape in K2_BITWISE:
            _k2_bitwise(fa, q, k, v, scale, k2_out, shape)
        if shape in K3A_BITWISE:
            _k3a_bitwise(fa, bwd, pairs["K3a"][0][0], shape)
        if d <= fa.MAX_D_BWD:
            log(_k3b_split(fa, device, shape))
        if shape in K3B_BITWISE:
            _k3b_bitwise(fa, bwd, pairs["K3b"][0], shape)
        del pairs, want_o, k2_out
        lib = {}
        for name, (kernel, plain, library) in runs.items():
            ms, plain_ms = adaptive_ms(kernel), adaptive_ms(plain)
            lib[name] = (adaptive_ms(library) if library else lib["K3a"])
            (n_bytes, n_ops, bound_ms, bound_by, roof,
             fp32_ms) = _attn_bound(name, shape)
            rows.append({"name": name, "shape": list(shape), "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib[name],
                         "bound_ms": bound_ms, "bound_by": bound_by})
            what = "SDPA backward (dq, dk, dv)" if name != "K2" else "SDPA"
            log(f"{name} {list(shape)}: {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, {what} {lib[name]:.5f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}, {roof}: {n_ops / 1e9:.3f} GFLOP; CUDA-core "
                f"bound {fp32_ms:.5f} ms; {n_ops / ms / 1e9:.2f} TFLOP/s "
                f"achieved)")
        del runs, bwd, q, k, v, do
        torch.cuda.empty_cache()
    return rows


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
    fwd, k3a, k3b = (big_n * attn_ms[(k, big)] + mid_n * attn_ms[(k, mid)]
                     for k in ("K2", "K3a", "K3b"))
    bwd = k3a + k3b
    step_ms = result["ms_per_step"]
    log(f"DDPM seconds: mask generation {t_mask:.3f} (whole CLI call), "
        f"unlearning {step_ms:.3f} ms/step over steps 2-{DDPM_ITERS} "
        f"(synchronised after a warm-up step; first step "
        f"{result['seconds']['first_step']:.3f} s), sampling "
        f"{stats['seconds']:.3f} s ({stats['images']} images, "
        f"{DDPM_STEPS} steps)")
    log(f"unlearning step: K2 {3 * fwd:.3f} ms + K3a/K3b {2 * bwd:.3f} ms "
        f"= {3 * fwd + 2 * bwd:.3f} ms of {step_ms:.3f} ms "
        f"({100 * (3 * fwd + 2 * bwd) / step_ms:.1f}%) at the phase-3 times; "
        f"K3a {2 * k3a:.3f} ms, K3b {2 * k3b:.3f} ms "
        f"({100 * 2 * k3b / step_ms:.1f}%)")
    return launches


# ------------------------------------------------------------------ phase 6


def write_sd_checkpoint(path: Path, device) -> int:
    """A CompVis ``.ckpt`` of the three models at the width of
    ``configs/sd/v1-inference.yaml`` with seeded random weights; no layer
    is left at zero (the zero-initialised ``proj_out``, ``out_layers.3``
    and ``out.2`` would zero every upstream gradient) and every norm's
    affine is moved off (1, 0). Returns the U-Net's parameter count."""
    import torch

    from salun_torch.ckpt import save_compvis
    from salun_torch.kernels.groupnorm_silu import GroupNormSiLU
    from salun_torch.sd.config import load_sd_config, modules_from_config

    sd = modules_from_config(load_sd_config(str(SD_CONFIG)), device, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)

    def randn(t, std):
        return std * torch.randn(t.shape, generator=gen, device=device)

    norms = (torch.nn.GroupNorm, torch.nn.LayerNorm, GroupNormSiLU)
    with torch.no_grad():
        for part in (sd.unet, sd.vae, sd.clip):
            for m in part.modules():
                if isinstance(m, norms):
                    m.weight.copy_(1.0 + randn(m.weight, 0.1))
                    m.bias.copy_(randn(m.bias, 0.1))
            for name, t in part.named_parameters():
                if not bool(t.any()):  # zero-initialised: re-draw
                    fan_in = t[0].numel() if t.dim() > 1 else 1
                    t.copy_(randn(t, 0.1 / math.sqrt(fan_in)))
                if not bool(t.any()):
                    fail(f"SD weight {name} is still zero")
    n_unet = sum(t.numel() for t in sd.unet.parameters())
    log(f"SD seeded weights: U-Net {n_unet}, VAE "
        f"{sum(t.numel() for t in sd.vae.parameters())}, CLIP "
        f"{sum(t.numel() for t in sd.clip.parameters())} parameters "
        f"(remat {sd.unet.cfg.remat})")
    save_compvis(str(path), sd)
    return n_unet


def write_imagenette_folder(root: Path) -> None:
    """``imagenette2/train/<wnid>/`` with SD_PER_CLASS non-square (400×320)
    seeded PNGs per class, so the loader's resize and center crop run."""
    import numpy as np

    from salun_torch.cli.ddpm_sample import write_png

    rng = np.random.default_rng(5)
    for c in range(10):
        d = root / "imagenette2" / "train" / f"n{c:08d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(SD_PER_CLASS):
            write_png(str(d / f"{i}.png"),
                      rng.integers(0, 256, (320, 400, 3)).astype(np.uint8))


def sd_step_attention_ms(cfg, rows) -> tuple:
    """(K2, K3a, K3b) ms of one random_label step from the phase-3 times
    at its shapes: three VAE encodes (one K2 each), three U-Net forwards
    plus the remat recompute of two (each attention site one K2) and two
    backwards (K3a and K3b per site); then the K2 ms of one U-Net forward
    and of one VAE attention at bs 4."""
    t = {(r["name"], tuple(r["shape"])): r["ms"] for r in rows}
    u = cfg.unet
    side = SD_IMAGE // 8
    sites = []
    for level, mult in enumerate(u.channel_mult):
        if 2 ** level in u.attention_resolutions:
            sites += [(level, mult)] * (2 * u.num_res_blocks + 1)
    sites.append((len(u.channel_mult) - 1, u.channel_mult[-1]))  # middle
    fwd = k3a = k3b = 0.0
    for level, mult in sites:
        n = (side >> level) ** 2
        d = mult * u.model_channels // u.num_heads
        for nk in (n, cfg.clip.max_length):  # attn1, attn2
            shape = (SD_BS * u.num_heads, n, nk, d)
            fwd += u.transformer_depth * t[("K2", shape)]
            k3a += u.transformer_depth * t[("K3a", shape)]
            k3b += u.transformer_depth * t[("K3b", shape)]
    vae = t[("K2", (SD_BS, side * side, side * side, 512))]
    n_fwd = 3 + (2 if u.remat else 0)
    return 3 * vae + n_fwd * fwd, 2 * k3a, 2 * k3b, fwd, vae


def sd_gn_sites(cfg, device) -> dict:
    """The [B, C, H, W] and eps of every K4 launch of one U-Net forward at
    bs ``SD_BS`` (``unet``; ``remat``: those the remat recompute repeats,
    all but ``out``), one VAE encode at bs ``SD_BS`` (``enc``) and one
    decode of ``SD_SAMPLES`` latents (``dec``), read by forward hooks on
    the ``GroupNormSiLU`` modules of seeded full-width models."""
    import torch

    from salun_torch.kernels.groupnorm_silu import GroupNormSiLU
    from salun_torch.sd.unet import SDUNet
    from salun_torch.sd.vae import AutoencoderKL

    sites = {"unet": [], "remat": [], "enc": [], "dec": []}

    def hook_all(model, key):
        for name, m in model.named_modules():
            if isinstance(m, GroupNormSiLU):
                keys = [key] + (["remat"] if key == "unet" and not
                                name.startswith("out.") else [])

                def record(mod, inp, out, keys=keys):
                    for k in keys:
                        sites[k].append((tuple(inp[0].shape), mod.eps))

                m.register_forward_hook(record)

    torch.manual_seed(6)
    side = SD_IMAGE // 8
    with torch.device(device), torch.no_grad():
        unet = SDUNet(cfg.unet)
        hook_all(unet, "unet")
        unet(torch.randn(SD_BS, cfg.unet.in_channels, side, side),
             torch.full((SD_BS,), 500.0),
             torch.randn(SD_BS, cfg.clip.max_length, cfg.unet.context_dim))
        del unet
        vae = AutoencoderKL(cfg.vae)
        hook_all(vae.encoder, "enc")
        hook_all(vae.decoder, "dec")
        vae.encode_moments(torch.randn(SD_BS, 3, SD_IMAGE, SD_IMAGE))
        vae.decode(torch.randn(SD_SAMPLES, cfg.vae.embed_dim, side, side))
        del vae
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sites


def sd_gn_ms(sites, ms, n_ddim: int) -> tuple:
    """(K4, K4b) ms of one random_label step (three VAE encodes, three
    U-Net forwards plus the remat recompute of two, two backwards) and
    the K4 ms of a sampling row (``n_ddim`` CFG forwards, one decode),
    from ``ms[(name, shape, eps)]`` at every site."""
    def total(name, key):
        return sum(ms[(name, shape, eps)] for shape, eps in sites[key])

    k4 = (3 * total("K4", "enc") + 3 * total("K4", "unet")
          + 2 * total("K4", "remat"))
    return k4, 2 * total("K4b", "unet"), (n_ddim * total("K4", "unet")
                                          + total("K4", "dec"))


def sd_gn_share(cfg, device, expect, step_ms: float, row_ms: float,
                n_ddim: int) -> None:
    """K4's and K4b's share of a random_label step and of a sampling row:
    each kernel and the library pair (``F.group_norm`` + ``F.silu``; their
    autograd backward) timed at every shape the sites give, times its
    launches. ``expect`` holds the launch counts the sites must match."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import groupnorm_silu as gn

    sites = sd_gn_sites(cfg, device)
    got = {k: len(v) for k, v in sites.items()}
    if got != expect:
        fail(f"GroupNormSiLU sites {got}, the path implies {expect}")
    ms = {}
    gen = torch.Generator(device=device).manual_seed(7)
    for shape, eps in sorted({s for v in sites.values() for s in v}):
        c = shape[1]
        x = torch.randn(shape, generator=gen, device=device)
        dy = torch.randn(shape, generator=gen, device=device)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=device)
        b = 0.3 * torch.randn(c, generator=gen, device=device)
        _, mean, rstd = gn.groupnorm_silu(x, w, b, 32, eps)
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
        lib_out = F.silu(F.group_norm(xl, 32, wl, bl, eps))
        ms[("K4", shape, eps)] = adaptive_ms(
            lambda: gn.groupnorm_silu(x, w, b, 32, eps), 40.0)
        ms[("K4b", shape, eps)] = adaptive_ms(
            lambda: gn.groupnorm_silu_backward(dy, x, w, b, mean, rstd, 32),
            40.0)
        ms[("lib", shape, eps)] = adaptive_ms(
            lambda: F.silu(F.group_norm(x, 32, w, b, eps)), 40.0)
        ms[("libb", shape, eps)] = adaptive_ms(
            lambda: torch.autograd.grad(lib_out, (xl, wl, bl), dy,
                                        retain_graph=True), 40.0)
        del x, dy, lib_out, xl
    k4, k4b, row = sd_gn_ms(sites, ms, n_ddim)
    lib = {("K4", s, e): ms[("lib", s, e)] for _, s, e in ms}
    lib.update({("K4b", s, e): ms[("libb", s, e)] for _, s, e in ms})
    lk4, lk4b, lrow = sd_gn_ms(sites, lib, n_ddim)
    log(f"random_label step: K4 {k4:.3f} ms + K4b {k4b:.3f} ms = "
        f"{k4 + k4b:.3f} ms of {step_ms:.3f} ms "
        f"({100 * (k4 + k4b) / step_ms:.1f}%) at {len(ms) // 4} shapes "
        f"timed here ({3 * got['enc'] + 3 * got['unet'] + 2 * got['remat']}"
        f" K4, {2 * got['unet']} K4b launches); F.group_norm + F.silu "
        f"there: {lk4:.3f} + {lk4b:.3f} = {lk4 + lk4b:.3f} ms. Sampling "
        f"row: K4 {row:.3f} ms of {row_ms:.3f} ms "
        f"({100 * row / row_ms:.1f}%; library pair {lrow:.3f} ms)")


def sd_path(device, attn_rows) -> dict:
    """The SD SalUn chain through the port's three CLIs; returns the
    launch counts of the whole chain."""
    import gc
    import os

    import torch

    from salun_torch.ckpt import load_compvis_state_dict, load_sd_mask
    from salun_torch.cli import sd_generate_images, sd_train
    from salun_torch.diffusion.sampling import ldm_uniform_timesteps
    from salun_torch.kernels import flash_attention as fa
    from salun_torch.kernels import groupnorm_silu as gn
    from salun_torch.kernels.masked_update import masked_sgd_update
    from salun_torch.sd.config import load_sd_config
    from salun_torch.sd.data import read_prompts_csv
    from salun_torch.sd.unet import kernel_sites

    os.environ["SALUN_CLIP_BPE"] = str(SD_MERGES)
    work = WORK / "sd"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt = work / "sd-v1-seeded.ckpt"
    n_unet = write_sd_checkpoint(ckpt, device)
    gc.collect()
    torch.cuda.empty_cache()
    write_imagenette_folder(work / "data")
    rows = read_prompts_csv(str(SD_PROMPTS))[:SD_ROWS]
    csv = work / "prompts.csv"
    csv.write_text("case_number,prompt,evaluation_seed\n" + "".join(
        f"{r['case_number']},{r['prompt']},{r['evaluation_seed']}\n"
        for r in rows))
    cfg = load_sd_config(str(SD_CONFIG))
    log(f"SD cuts: {SD_PER_CLASS} forget images (of 16 per class, 10 "
        f"classes, synthetic non-square PNGs) instead of 64; random_label "
        f"{SD_EPOCHS} epochs instead of 5 (bs {SD_BS}, lr {SD_LR}, alpha "
        f"{SD_ALPHA}, full, remat); {SD_ROWS} prompt rows x {SD_SAMPLES} "
        f"samples at {SD_STEPS} DDIM steps instead of 100, guidance "
        f"{SD_GUIDANCE}, {SD_IMAGE}x{SD_IMAGE}; synthetic BPE merges")

    kernels = {"K1 masked_sgd_update": masked_sgd_update,
               "K2 flash_attention_fwd": fa.flash_attention_fwd,
               "K3a flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
               "K3b flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
               "K4 groupnorm_silu": gn.groupnorm_silu,
               "K4b groupnorm_silu_backward": gn.groupnorm_silu_backward}

    def counts():
        return {k: f.launches for k, f in kernels.items()}

    def since(before):
        return {k: n - before[k] for k, n in counts().items()}

    common = ["--config", str(SD_CONFIG), "--ckpt_path", str(ckpt),
              "--data", str(work / "data"), "--image_size", str(SD_IMAGE),
              "--batch_size", str(SD_BS), "--class_to_forget", "0",
              "--device", str(device)]
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    sd_train.main(["generate_mask", *common, "--num_samples",
                   str(SD_PER_CLASS), "--threshold", "0.5",
                   "--save_dir", str(work / "mask")])
    t_mask = time.perf_counter() - t0
    got = {"mask": counts()}
    gc.collect()
    torch.cuda.empty_cache()
    mask_file = work / "mask" / "mask" / "0" / "with_0.5.pt"
    before = counts()
    result = sd_train.main(["random_label", *common, "--mask_path",
                            str(mask_file), "--epochs", str(SD_EPOCHS),
                            "--lr", str(SD_LR), "--alpha", str(SD_ALPHA),
                            "--train_method", "full", "--remat",
                            "--save_dir", str(work / "rl")])
    got["random_label"] = since(before)
    gc.collect()
    torch.cuda.empty_cache()
    before = counts()
    stats = sd_generate_images.main([
        "--prompts_path", str(csv), "--config", str(SD_CONFIG),
        "--ckpt_path", str(work / "rl" / "compvis.ckpt"),
        "--save_path", str(work / "images"), "--num_samples",
        str(SD_SAMPLES), "--ddim_steps", str(SD_STEPS), "--guidance_scale",
        str(SD_GUIDANCE), "--image_size", str(SD_IMAGE), "--device",
        str(device)])
    torch.cuda.synchronize()
    got["sample"] = since(before)
    gc.collect()
    torch.cuda.empty_cache()

    # exact-k 0.5 mask over the U-Net
    mask = load_sd_mask(str(mask_file), device)
    n_mask = sum(v.numel() for v in mask.values())
    ones = int(sum(int(v.sum()) for v in mask.values()))
    if n_mask != n_unet or ones != int(n_unet * 0.5):
        fail(f"SD 0.5 mask has {ones} ones of {n_mask}, want "
             f"{int(n_unet * 0.5)} of {n_unet}")
    log(f"SD mask 0.5: exactly {ones} of {n_unet} ones")

    # masked-out U-Net weights pinned to θ₀ bitwise; VAE and CLIP unchanged
    theta0 = load_compvis_state_dict(str(ckpt))
    after = load_compvis_state_dict(str(work / "rl" / "compvis.ckpt"))
    if set(theta0) != set(after):
        fail("compvis.ckpt holds other keys than the seeded checkpoint")
    moved = 0
    prefix = "model.diffusion_model."
    for key, new in after.items():
        new, old = new.to(device), theta0[key].to(device)
        if not key.startswith(prefix):
            if not torch.equal(new, old):
                fail(f"frozen SD weight {key} changed")
            continue
        keep = mask[key[len(prefix):]] > 0
        if not torch.equal(new[~keep], old[~keep]):
            fail(f"SD {key}: a masked-out weight left θ₀")
        moved += int((new[keep] != old[keep]).sum())
    if moved == 0:
        fail("random_label moved no kept weight")
    log(f"after random_label: every masked-out U-Net weight equals θ₀ "
        f"bitwise, the VAE and CLIP are unchanged bitwise; {moved} kept "
        f"weights moved")
    del theta0, after, mask

    # launches as the path implies
    unet = kernel_sites(cfg.unet)
    vae_k4 = {"enc": 2 * len(cfg.vae.ch_mult) * cfg.vae.num_res_blocks + 5,
              "dec": 2 * len(cfg.vae.ch_mult) * (cfg.vae.num_res_blocks + 1)
              + 5}
    n_batches = -(-SD_PER_CLASS // SD_BS)
    n_steps = SD_EPOCHS * (SD_PER_CLASS // SD_BS)
    n_ddim = len(ldm_uniform_timesteps(cfg.timesteps, SD_STEPS)[:-1])
    k2_fwd, k4_fwd = unet["k2"], unet["k4"]
    k2_re, k4_re = unet["k2_remat"], unet["k4_remat"]
    names = list(kernels)

    def want(k1, k2, k3, k4, k4b):
        return dict(zip(names, (k1, k2, k3, k3, k4, k4b)))

    # mask: per batch a VAE encode, one U-Net forward with its backward
    # (and the remat recompute); random_label: per step three VAE encodes,
    # three U-Net forwards (remain, forget, pseudo) and two backwards;
    # sampling: per row one CFG forward per DDIM step and a VAE decode
    expect = {
        "mask": want(0, n_batches * (1 + k2_fwd + k2_re), n_batches * k2_fwd,
                     n_batches * (vae_k4["enc"] + k4_fwd + k4_re),
                     n_batches * k4_fwd),
        "random_label": want(0, n_steps * (3 + 3 * k2_fwd + 2 * k2_re),
                             n_steps * 2 * k2_fwd,
                             n_steps * (3 * vae_k4["enc"] + 3 * k4_fwd
                                        + 2 * k4_re),
                             n_steps * 2 * k4_fwd),
        "sample": want(0, SD_ROWS * (n_ddim * k2_fwd + 1), 0,
                       SD_ROWS * (n_ddim * k4_fwd + vae_k4["dec"]), 0)}
    if got != expect:
        fail(f"SD launches {got}, the path implies {expect}")
    log(f"SD launches as the path implies (per U-Net forward {k2_fwd} K2, "
        f"{k4_fwd} K4; remat recompute {k2_re} K2, {k4_re} K4): mask "
        f"{got['mask']} ({n_batches} batches), random_label "
        f"{got['random_label']} ({n_steps} steps), sampling "
        f"{got['sample']} ({SD_ROWS} rows x {n_ddim} steps)")

    losses = result["losses"]
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        fail(f"random_label losses {losses}")
    pngs = sorted(os.listdir(work / "images"))
    want_pngs = sorted(f"{r['case_number']}_{i}.png" for r in rows
                       for i in range(SD_SAMPLES))
    if not (stats["finite"] and 0.0 <= stats["min"] <= stats["max"] <= 1.0
            and stats["images"] == SD_ROWS * SD_SAMPLES
            and pngs == want_pngs):
        fail(f"SD images {stats}, files {pngs}")
    log(f"random_label losses finite: {[round(x, 5) for x in losses]}; "
        f"{stats['images']} images finite in [{stats['min']:.4f}, "
        f"{stats['max']:.4f}], PNGs {pngs}")
    step_ms = result["ms_per_step"]
    log(f"SD seconds: mask generation {t_mask:.3f} (whole CLI call, "
        f"{SD_PER_CLASS} images), random_label {step_ms:.3f} "
        f"ms/step over steps 2-{n_steps} (first step "
        f"{result['seconds']['first_step']:.3f} s), sampling "
        f"{stats['seconds']:.3f} s ({stats['images']} images, {n_ddim} "
        f"steps)")
    k2_ms, k3a_ms, k3b_ms, fwd_ms, vae_ms = sd_step_attention_ms(cfg,
                                                                 attn_rows)
    k3_ms = k3a_ms + k3b_ms
    log(f"random_label step: K2 {k2_ms:.3f} ms + K3a/K3b {k3_ms:.3f} ms = "
        f"{k2_ms + k3_ms:.3f} ms of {step_ms:.3f} ms "
        f"({100 * (k2_ms + k3_ms) / step_ms:.1f}%) at the phase-3 times; "
        f"K3a {k3a_ms:.3f} ms, K3b {k3b_ms:.3f} ms "
        f"({100 * k3b_ms / step_ms:.1f}%)")
    # a sampling row: one CFG-doubled U-Net forward (bs 2 x 2 = 4, the
    # step's shapes) per DDIM step, then a decode of SD_SAMPLES latents
    # (its K2 at SD_SAMPLES / SD_BS of the bs-4 time)
    row_ms = 1e3 * stats["seconds"] / SD_ROWS
    row_k2 = n_ddim * fwd_ms + vae_ms * SD_SAMPLES / SD_BS
    log(f"sampling row: K2 {row_k2:.3f} ms ({n_ddim} x {fwd_ms:.3f} ms "
        f"per U-Net forward + the decode's) of {row_ms:.3f} ms "
        f"({100 * row_k2 / row_ms:.1f}%) at the phase-3 times")
    sd_gn_share(cfg, device, {"unet": k4_fwd, "remat": k4_re,
                              "enc": vae_k4["enc"], "dec": vae_k4["dec"]},
                step_ms, row_ms, n_ddim)
    total = {k: sum(g[k] for g in got.values()) for k in names}
    shutil.rmtree(work, ignore_errors=True)
    return total


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
    gn_entries, _ = groupnorm_vs_plain(device)
    kernels += gn_entries
    sd_attn_rows = sd_attention_vs_plain(device)
    masks_card_vs_cpu(device)

    # the main paths through the CLIs (TF32 on), each counted on its own
    by_path = {"classification": main_path(device, kernels[0]["ms"]),
               "ddpm": ddpm_path(device, attn_ms),
               "sd": sd_path(device, sd_attn_rows)}
    log(f"TF32 on the main paths: {tf32_settings()}")
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()
                                 if k["name"] in n}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
