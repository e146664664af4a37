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
   shape), 15,334,948 (vgg16_bn, 100 classes), 23,705,252 (ResNet-50,
   CIFAR stem, 100 classes) and 11,174,475 (ResNet-18 with
   boundary_expanding's 11-way head: odd, so the float4 path has a
   3-element tail), one kernel-table row each, 50%-dense mask,
   two learning rates: bitwise equal (``torch.equal``). K2, K3a and K3b (flash attention forward, dq, dk/dv)
   against their plain versions at the DDPM path's shapes ([B, N, D] =
   [128, 256, 256], [256, 256, 256], [128, 16, 256]) and ragged ones (N =
   77, Nq ≠ Nk, D = 40, 64, 160, 8): max abs and relative error, failing
   above 1e-4·max(1, max|plain|); K2 launched twice at [128, 256, 256,
   256], [32, 1024, 1024, 80] and [4, 4096, 4096, 512] gives bitwise equal
   o and lse, K3a launched twice at [128, 256, 256, 256], [32, 4096, 4096,
   40] and [128, 16, 16, 256] bitwise equal dq, K3b launched twice at
   [128, 256, 256, 256], [32, 4096, 4096, 40] and [32, 4096, 77, 40] (a
   split query walk) bitwise equal dk and dv; K3b's split count is logged
   at every shape. The FIM's vmapped shapes [8, 256, 256, 256] (where K3b
   must split its query walk) and [8, 16, 16, 256] are checked the same
   way, untimed; then one batch of ``compute_fim`` (8 samples under
   ``vmap``, one timestep) on the CIFAR-10 FIM U-Net through the kernels
   is held against the same batch with the plain versions in their place,
   each tensor within 1e-4 of its own largest entry. All three multiply
   on the tensor cores in 3xTF32. Times with CUDA events, the bound (the
   operations at the 3xTF32 tensor-core roof, 495/3 TFLOP/s, with the
   fp32 CUDA-core bound beside it), the plain version's time and, for
   K2/K3, the time of
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
   1024, 256, 64 and D = 40, 80, 160, 160) with K3a/K3b there, K2 at
   ESD's shapes (the student's CFG chain at batch 1, [16, N, N or 77, D],
   and the teacher's [8, 4096, 4096 or 77, 40]) with K3a/K3b at the latter
   (K3b's split walk at Nk = 77), and K2 at the VAE's D = 512 ([4, 4096,
   4096, 512]). K2, K3a and K3b at the
   STL-10 U-Net's mid block [128, 16, 16, 512] the same way, K3a and K3b
   there on kernel rows of their own, with the SDPA backend PyTorch picks
   at each of the DDPM path's shapes named. Saliency masks on the card
   against the CPU's on a heavily tied input: bitwise.
4. Classification main path at full width: synthetic CIFAR-shaped data
   written in the CIFAR-10 file format, a seeded ResNet-18, then the
   port's own entry points ``salun_torch.cli.generate_mask`` (masks at
   0.1…1.0) and ``salun_torch.cli.main_random --unlearn RL`` (lr 0.013,
   bs 256, one epoch) with UA/RA/TA and SVC-MIA. Checks: the 0.5 mask has
   exactly int(N/2) ones; after RL every masked-out weight equals θ₀
   bitwise; K1's launch count equals the optimizer steps; every metric is
   finite.
4b. The rest of the classification workload, through the port's CLIs on
   the card (TF32 on), cut to 1 epoch each on phase 4's 12,000/2,000
   images:
   - ``main_random --unlearn GA | GA_l1 | FT | FT_l1`` with phase 4's
     ResNet-18 and 0.5 mask: every masked-out weight equals θ₀ bitwise,
     some kept weight moved, K1 launches = optimizer steps (GA: ⌈forget /
     bs⌉, FT: ⌈retain / bs⌉), UA/RA/TA and SVC-MIA finite;
   - ``main_forget --unlearn FT`` (no mask) and ``--unlearn retrain``
     (from the seeded init): K1 launches 0 times, metrics finite;
   - ``main_train`` on ResNet-18 (lr 0.1, bs 256): 2 epochs straight,
     then 1 epoch and ``--resume`` to 2 in a fresh directory, with cuDNN
     deterministic for these calls: the resumed checkpoint (weights, BN
     statistics, momentum, step count) equals the straight run's bitwise;
     seconds per epoch and images/s printed;
   - vgg16_bn and ResNet-50 (CIFAR stem) at full width on synthetic
     CIFAR-100 files (12,000/2,000 images, 100 classes, 1,000 forget):
     ``generate_mask``, then ``main_random --unlearn RL`` with the 0.5 mask
     for 1 epoch (CIFAR-100's relabel-and-concat regime). Checks: the
     model's parameter count (printed) equals the constant of K1's row and
     the mask's size, the mask is exact-k, θ₀ pinned bitwise, K1
     launches = ⌈(forget + retain) / bs⌉, metrics finite.
4c. The exact k-th value (``salun_torch.dist.topk``) on the card against
   ``torch.sort``'s, bitwise, at N = 11,173,962 for k = 1, ⌈N/2⌉, N (int
   and tensor k), on normals and on a 16-level grid of ties. Then the ten
   other methods through the CLIs on phase 4's data, ResNet-18 and 0.5
   mask: ``main_random --unlearn boundary_shrink | boundary_expanding |
   FT_prune | wfisher`` and ``main_forget --unlearn fisher | fisher_new |
   RL_proximal | FT_prune_bi | GA_prune_bi | GA_prune``. Cuts, printed: 1
   epoch each, FT_prune_bi and GA_prune_bi 2 (one prune round); fisher and
   fisher_new over the first 2,560 retain images. Checks: K1 launches
   once a step of boundary_shrink (4), boundary_expanding (4, on its own
   kernel-table row, the widened model's 11,174,475 parameters checked)
   and FT_prune (39), never on the other seven; masked-out weights equal
   θ₀ bitwise after every main_random call (on the widened model over the
   old rows); RL_proximal leaves at least the last step's ratio of weights
   at θ_init; FT_prune_bi, GA_prune_bi and GA_prune zero exactly their
   prune count of conv weights; every weight and metric finite. Prints
   seconds per call and its unlearning loop, ms per retain batch of the
   fisher methods, UA/RA/TA and SVC-MIA.
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
5b. The rest of DDPM training and sampling through the port's CLIs, at
   the full width of ``configs/ddpm/cifar10_train.yml`` (35.7M parameters,
   EMA 0.9999) on phase 5's synthetic CIFAR files: ``ddpm_train --mode
   train`` 20 steps, ``retrain`` 20 steps, ``train`` 10 steps then
   ``--resume`` to 20 (cuDNN deterministic for the straight run and the
   pair), ``ddpm_fim`` (``configs/ddpm/cifar10_fim.yml``) over 32 images
   at 16 timesteps, batch 8, the SA remember set (16 samples of each kept
   class by ``ddpm_sample``), ``--mode forget``
   (``configs/ddpm/cifar10_forget.yml``) 20 steps, ``ddpm_sample
   sample_fid`` (2 classes × 16), ``sample_visualization`` and
   ``sample_trajectory`` at 50 DDIM steps, and ``ddpm_save_base``. Then
   STL-10 at the full width of ``configs/ddpm/stl10_train.yml`` (64x64,
   ch_mult [1, 2, 2, 2, 4]; the mid block's attention at D = 512) on
   synthetic ``stl10_binary/train_{X,y}.bin`` at 96x96, resized to 64:
   ``train`` 20 steps, ``generate_mask``, 2 classes × 16 samples. Each
   call's K2/K3a/K3b launches are counted on their own and must be what
   the call implies (the FIM's vmapped gradients one launch a site a
   timestep batch; K3a/K3b at D = 512 once a train step and a mask batch
   on STL-10, counted apart); the resumed state (model, Adam state, step,
   EMA) equals the straight run's bitwise; the EMA differs from the
   parameters; retrain never sees class 0, nor does forget's remember
   set; the FIM is finite and non-negative; losses and images finite,
   images in [0, 1]; ``ddpm_save_base`` writes 500 PNGs of each kept
   class. Prints ms per step over steps 2–20 of every training mode, the
   FIM seconds, the sampling seconds and the U-Net parameter counts.
5c. DDPM evaluation on phase 5b's outputs: the port's InceptionV3 (seeded
   He-normal init; no pytorch-fid weights in the checkout) on the card
   against the CPU at TF32 off, pool, sFID spatial and softmax of 8
   images of 32×32 within 1e-4·max(1, max|CPU|); its feature rate over
   2,560 images; the FID of those images against themselves ≤
   1e-6·max(1, tr Σ); ``salun_torch.cli.ddpm_evaluator`` over phase 5b's
   ``sample_fid`` folder against 64 synthetic CIFAR PNGs (every metric
   finite, the CSV row written); ``salun_torch.cli.ddpm_classifier
   train`` (ResNet-34 at 224, bs 64, 4 steps) and ``--freeze_layers``
   (the body bitwise the seeded init, the head moved), then ``eval`` over
   class 0's samples (probabilities summing to 1, the three metrics
   finite). No port kernel runs here.
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
6b. The other SD trainers on phase 6's checkpoint, data and 0.5 mask,
   through ``salun_torch.cli.sd_train`` (bs 4, lr 1e-5, full, remat):
   ``gradient_ascent`` and ``proximal`` (``--mask_ratio 0.9``) 1 epoch = 4
   steps, ``nsfw_removal`` 2 steps over 8 + 8 synthetic PNGs, ``esd`` 4
   iterations at 50 DDIM steps (no mask), ``random_label
   --cache_vae_moments`` 4 steps. Checks: K2/K3a/K3b/K4/K4b launch exactly
   as each path implies (ESD's from the t_enc each iteration drew);
   masked-out weights stay θ₀ bitwise, the VAE and CLIP unchanged;
   proximal's shrink counts follow JAX's schedule, each leaves at least
   its count at θ₀, and its exact k-th value equals ``torch.sort``'s on
   the final 859.5M |θ − θ₀|; ESD's teacher stays the seeded U-Net
   bitwise; the cached run's losses equal phase 6's first 4 within 1e-4
   relative. Prints ms per step over steps 2+, proximal's peak memory and
   the cache's precompute seconds.
7. A ``{"kernels": [...]}`` line (launches per path and in all; K1's
   ResNet-18 row counts the ResNet-18 paths, its vgg16_bn and ResNet-50
   rows their RL paths, its boundary_expanding row that call; K3a's and
   K3b's D = 512 rows their launches at D = 512 on STL-10), the card's
   name and power limit, and as the last
   line ``{"ok": true, "device": {...}}``.

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
N_VGG16_BN = 15_334_948    # vgg16_bn, 100 classes
N_RESNET50 = 23_705_252    # ResNet-50 (CIFAR stem), 100 classes
N_K1_WIDE = N_K1 + 513     # boundary_expanding's ResNet-18 with 11 outputs
# K1's rows: (kernel-table name, N); the first is the ResNet-18 paths'
K1_NAME = "K1 masked_sgd_update"
K1_ROWS = [(K1_NAME, N_K1), (f"{K1_NAME} vgg16_bn", N_VGG16_BN),
           (f"{K1_NAME} resnet50", N_RESNET50),
           (f"{K1_NAME} boundary_expanding", N_K1_WIDE)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32, outside the tensor cores
TF32X3_FLOPS = 495e12 / 3  # H100 SXM TF32 dense, three products (3xTF32)

# Main-path data: CIFAR-shaped, cut in count from CIFAR-10's 50,000/10,000
N_TRAIN, N_TEST, N_FORGET = 12_000, 2_000, 1_000
BATCH, LR, EPOCHS = 256, 0.013, 1
TRAIN_EPOCHS = 2  # main_train: straight, and 1 + --resume
PRUNE_BI_EPOCHS = 2  # *_prune_bi prune when (E - epoch) % 2 == 0
FISHER_RETAIN = 2_560  # fisher/fisher_new: retain images (per-sample grads)

# Flash attention: the DDPM path's [B, N, D] (bs 128 unlearning, the CFG-
# doubled bs 256 of mask generation, the 4x4 mid block; the STL-10 U-Net's
# 4x4 mid block at 512 channels, bs 128) and ragged shapes (B, Nq, Nk, D)
ATTN_PATH = [(128, 256, 256, 256), (256, 256, 256, 256), (128, 16, 16, 256),
             (128, 16, 16, 512)]
ATTN_STL_MID = ATTN_PATH[3]
ATTN_RAGGED = [(3, 77, 77, 64), (2, 100, 77, 40), (4, 33, 65, 160),
               (2, 1, 5, 8)]
ATTN_TOL = 1e-4  # × max(1, max|plain|): fp32 sums in other orders
# K2 launched twice must give the same o and lse, bitwise (no atomics)
K2_BITWISE = [(128, 256, 256, 256), (32, 1024, 1024, 80),
              (4, 4096, 4096, 512)]
# K3a the same for dq
K3A_BITWISE = [(128, 256, 256, 256), (32, 4096, 4096, 40),
               (128, 16, 16, 256), (128, 16, 16, 512)]
# K3b the same for dk and dv; [32, 4096, 77, 40] takes the split walk
K3B_BITWISE = [(128, 256, 256, 256), (32, 4096, 4096, 40),
               (32, 4096, 77, 40), (128, 16, 16, 512)]
# K3a's and K3b's rows at the STL-10 mid block: their launches there are
# counted apart (the kernels' D = 512 instantiations)
D512_ROWS = {"K3a": "K3a flash_attention_bwd_dq D=512",
             "K3b": "K3b flash_attention_bwd_dkv D=512"}

# DDPM chain: the reference config, cut in count and steps
DDPM_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_saliency_unlearn.yml"
DDPM_SAMPLE_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_sample.yml"
DDPM_PER_CLASS, DDPM_ITERS = 500, 20
DDPM_SAMPLES, DDPM_STEPS, DDPM_CLASSES = 16, 50, (0, 1)
# phase 5b: the rest of DDPM training and sampling, cut the same way
DDPM_TRAIN_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_train.yml"
DDPM_FIM_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_fim.yml"
DDPM_FORGET_CONFIG = ROOT / "configs" / "ddpm" / "cifar10_forget.yml"
STL10_CONFIG = ROOT / "configs" / "ddpm" / "stl10_train.yml"
FIM_SAMPLES, FIM_BATCH, FIM_TIMESTEPS = 32, 8, 16
# the FIM's attention: vmap folds FIM_BATCH samples into B (checked
# against plain, not timed); at the first K3b takes its split walk
ATTN_FIM = [(FIM_BATCH, 256, 256, 256), (FIM_BATCH, 16, 16, 256)]
FIM_TOL = 1e-4  # × each tensor's own max FIM entry (fp32, other orders)
FIM_ZERO = 1e-9  # × the largest entry: below it a tensor's FIM is 0

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
# ESD's attention (phase 6b): the student's CFG-doubled chain at batch 1
# (2 x 8 heads) and the teacher's and the trained forward at batch 1
# (8 heads); K3a/K3b at the latter's level-0 self and cross attention
ATTN_SD_ESD = [(16, 4096, 4096, 40), (16, 4096, 77, 40), (16, 1024, 1024, 80),
               (16, 256, 256, 160), (16, 64, 64, 160), (8, 4096, 4096, 40),
               (8, 4096, 77, 40)]
ATTN_SD_ESD_BWD = [(8, 4096, 4096, 40), (8, 4096, 77, 40)]

# SD chain: configs/sd/v1-inference.yaml at full width, seeded weights;
# cut in count (16 forget images instead of 64, 2 epochs instead of 5,
# 2 prompt rows × 2 samples at 50 DDIM steps instead of 100)
SD_CONFIG = ROOT / "configs" / "sd" / "v1-inference.yaml"
SD_PROMPTS = ROOT / "prompts" / "imagenette.csv"
SD_MERGES = ROOT / "tests" / "_synthetic_clip_merges.txt"
SD_IMAGE, SD_PER_CLASS, SD_BS = 512, 16, 4
SD_EPOCHS, SD_LR, SD_ALPHA = 2, 1e-5, 0.5
SD_ROWS, SD_SAMPLES, SD_STEPS, SD_GUIDANCE = 2, 2, 50, 7.5
# phase 6b: the other SD trainers on phase 6's checkpoint and data, cut
# to 1 epoch (4 steps at bs 4; nsfw_removal 2 over 8 + 8 PNGs); ESD 4
# iterations (of 1,000) at 50 DDIM steps; proximal's --mask_ratio 0.9 (with
# the 0.5 mask half the U-Net sits at θ₀, so the default 0.5's ratio lands
# in those zeros and τ = 0)
SD_NSFW_IMAGES, SD_ESD_ITERS, SD_PROX_RATIO = 8, 4, 0.9
SD_CACHE_TOL = 1e-4  # relative, cached against uncached losses (TF32 on)

# phase 5c: FID/Inception and the DDPM classifier on phase 5b's samples
INCEPTION_CHECK, INCEPTION_TOL = 8, 1e-4  # images; × max(1, max|CPU|)
FID_REF, FID_TIMED = 64, 2_560  # reference PNGs; images timed (> 2,048)
FID_SELF_TOL = 1e-6  # a set's FID against itself, × max(1, tr Σ)
CLS_LIMIT, CLS_BS = 256, 64  # ddpm_classifier train: 4 steps at 224 px


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


def k1_vs_plain(device, name: str, n: int) -> dict:
    """K1 against its plain version at ``n`` elements: bitwise, timed."""
    import torch

    from salun_torch.kernels.masked_update import (
        masked_sgd_update, masked_sgd_update_reference)

    gen = torch.Generator(device=device).manual_seed(0)
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
            fail(f"K1 differs from its plain version at N = {n}, "
                 f"lr={lr_value}: max abs err {err}")
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
    log(f"K1 N = {n}: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({n_bytes} bytes), {n_bytes / ms / 1e6:.1f} GB/s")
    return {"name": name, "route": "cuda",
            "source": "salun_torch/csrc/masked_sgd.cu",
            "replaces": "salun/kernels/masked_update.py:27", "n": n,
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


def sdpa_backend(q, k, v, do, scale) -> str:
    """The backend ``scaled_dot_product_attention`` dispatches to for a
    forward and backward at these inputs: the first, in PyTorch's priority
    order, that runs them when it is the only one allowed."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    for b in torch._C._get_sdp_priority_order():
        name = names.get(int(b), str(b))
        if name in ("ERROR", "OVERRIDEABLE"):
            continue
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                torch.autograd.grad(out, (ql, kl, vl), do)
            return name
        except RuntimeError:
            continue
    return "none"


def attention_vs_plain(device):
    """K2, K3a and K3b against their plain versions at the path's, the
    ragged and the FIM's shapes; times at the path's shapes. Returns the
    three kernel
    entries (at the bs-128 training shape) and ``{(name, shape): ms}``."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import flash_attention as fa

    names = {"K2": "K2 flash_attention_fwd", "K3a": "K3a flash_attention_bwd_dq",
             "K3b": "K3b flash_attention_bwd_dkv"}
    max_err = dict.fromkeys(names, 0.0)
    shape_err = {}
    times = {}
    gen = torch.Generator(device=device).manual_seed(2)
    for shape in ATTN_PATH + ATTN_RAGGED + ATTN_FIM:
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
                shape_err[(name, shape)] = max(
                    shape_err.get((name, shape), 0.0), err)
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
        if shape == ATTN_FIM[0] and fa.dkv_split_plan(
                *shape, fa.dkv_resident_blocks(device, shape[3]))[0] < 2:
            fail(f"K3b does not split its query walk at the FIM's "
                 f"{list(shape)}, so the split walk is unchecked there")
        if shape in K3B_BITWISE:
            _k3b_bitwise(fa, bwd, pairs["K3b"][0], shape)
        if shape not in ATTN_PATH:
            continue
        log(f"SDPA {list(shape)}: the {sdpa_backend(q, k, v, do, scale)} "
            f"backend (forward and backward)")
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
    # each kernel's row at the training shape (its error over every shape)
    # and K3a's and K3b's at the STL-10 mid block (the error there)
    rows = [(name, full, ATTN_PATH[0], max_err[name])
            for name, full in names.items()]
    rows += [(name, full, ATTN_STL_MID, shape_err[(name, ATTN_STL_MID)])
             for name, full in D512_ROWS.items()]
    entries = []
    for name, full, shape, err in rows:
        (ms, plain_ms, lib_ms, bound_ms, bound_by,
         roof) = times[(name, shape)]
        entries.append({
            "name": full, "route": "cuda",
            "source": "salun_torch/csrc/flash_attention.cu",
            "replaces": "salun/kernels/flash_attention.py" + sources[name],
            "shape": list(shape), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roof": roof, "library_ms": lib_ms})
    return entries, {key: t[0] for key, t in times.items()}


def fim_vs_plain(device) -> None:
    """One batch of ``compute_fim`` (FIM_BATCH samples under ``vmap``, one
    timestep, injected t, noise and flips) on the CIFAR-10 FIM U-Net at
    seeded random weights, through K2/K3a/K3b, held per tensor against
    the same batch with the attention wrappers' plain versions in their
    place. TF32 off and cuDNN deterministic, so the attention is all that
    differs. A tensor whose FIM is below FIM_ZERO of the largest entry is
    0 in exact arithmetic (attention's k bias): held at FIM_TOL of that
    floor."""
    import numpy as np
    import torch

    from salun_torch.cli.ddpm_config import load_config
    from salun_torch.diffusion.runner import DDPMRunner
    from salun_torch.diffusion.unet import attention_sites
    from salun_torch.kernels import flash_attention as fa

    bundle = load_config(str(DDPM_FIM_CONFIG))
    runner = DDPMRunner(bundle.unet, bundle.schedule, bundle.train, device)
    model = runner.init(0)
    size, n = bundle.unet.image_size, FIM_BATCH
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (n, size, size, 3), np.uint8),
             "label": rng.integers(0, bundle.unet.n_classes, n, np.int32),
             "flips": torch.from_numpy(rng.random(n) < 0.5),
             "t": torch.from_numpy(rng.integers(
                 0, bundle.schedule.num_timesteps, (n, 1))),
             "e": torch.from_numpy(rng.standard_normal(
                 (1, n, 3, size, size), np.float32))}

    def plain_fwd(q, k, v, scale, need_lse=False):
        o, lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        return o, (lse if need_lse else None)

    plain = {"flash_attention_fwd": plain_fwd,
             "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_reference,
             "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_reference}
    kernels = _attention_kernels()
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        for f in kernels.values():
            f.launches = 0
        got = runner.compute_fim(model, [batch], n_timestep_samples=1)
        torch.cuda.synchronize()
        launches = [f.launches for f in kernels.values()]
        if launches != [attention_sites(bundle.unet)] * 3:
            fail(f"FIM vs plain: K2/K3a/K3b launches {launches}, one a "
                 f"site expected")
        for name, fn in plain.items():
            setattr(fa, name, fn)
        want = runner.compute_fim(model, [batch], n_timestep_samples=1)
        torch.cuda.synchronize()
    finally:
        for name, fn in zip(plain, kernels.values()):
            setattr(fa, name, fn)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was
    floor = FIM_ZERO * max(float(w.max()) for w in want.values())
    if not floor > 0 or not math.isfinite(floor):
        fail(f"FIM vs plain: the plain FIM's largest entry is {floor}")
    worst, zero = (0.0, ""), 0
    for name, w in want.items():
        scale = max(float(w.max()), floor)
        zero += float(w.max()) < floor
        ratio = float((got[name] - w).abs().max()) / scale
        worst = max(worst, (ratio, name))
        if not ratio <= FIM_TOL:
            fail(f"FIM vs plain: {name} differs by {ratio:.3e} of its "
                 f"largest entry {scale:.3e}")
    log(f"FIM vs plain ({n} samples under vmap, launches {launches}): "
        f"{len(want)} tensors, worst {worst[0]:.3e} of the tensor's own "
        f"max ({worst[1]}); {zero} tensor(s) 0 in exact arithmetic")


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
    """K2 at the U-Net's self- and cross-attention shapes, at ESD's and at
    D = 512 (the VAE), K3a/K3b at the U-Net's and ESD's trained forward:
    errors against the plain versions,
    times against the bound, the plain version and SDPA. Returns the
    per-shape rows."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import flash_attention as fa

    rows = []
    gen = torch.Generator(device=device).manual_seed(4)
    for shape in ATTN_SD_UNET + ATTN_SD_ESD + ATTN_SD_VAE:
        b, nq, nk, d = shape
        backward = shape in ATTN_SD_UNET or shape in ATTN_SD_ESD_BWD
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
        if backward:  # no SalUn path trains the VAE
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
        if backward:
            log(_k3b_split(fa, device, shape))
        if shape == ATTN_FIM[0] and fa.dkv_split_plan(
                *shape, fa.dkv_resident_blocks(device, shape[3]))[0] < 2:
            fail(f"K3b does not split its query walk at the FIM's "
                 f"{list(shape)}, so the split walk is unchecked there")
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


def check_pinned(mask: dict, before: Path, after: Path, what: str) -> None:
    """Every masked-out weight of the checkpoint ``after`` equals the one
    of ``before`` bitwise, and some kept weight moved (on a widened
    output layer, over the rows the mask covers)."""
    import torch

    from salun_torch.ckpt import load_state_dict

    theta0, out = load_state_dict(str(before)), load_state_dict(str(after))
    moved = 0
    for name, m in mask.items():
        # a widened output layer (boundary_expanding): its old rows
        out_w = out[name][tuple(slice(0, s) for s in m.shape)]
        in_w = theta0[name]
        if not torch.equal(out_w[m == 0], in_w[m == 0]):
            fail(f"{what}: {name}: a masked-out weight left θ₀")
        moved += int((out_w[m > 0] != in_w[m > 0]).sum())
    if moved == 0:
        fail(f"{what} moved no kept weight")
    log(f"after {what}: every masked-out weight equals θ₀ bitwise; "
        f"{moved} kept weights moved")


def check_metrics(results: dict, what: str) -> None:
    """UA/RA/TA and the five SVC-MIA numbers are finite."""
    mia = results["SVC_MIA_forget_efficacy"]
    values = [results[k] for k in ("retain", "forget", "val", "test", "UA")]
    values += [mia[k] for k in ("correctness", "confidence", "entropy",
                                "m_entropy", "prob")]
    if len(mia) != 5 or not all(math.isfinite(v) for v in values):
        fail(f"{what}: non-finite metrics: {results}")


def unlearn_loaders(argv):
    """The forget/retain/val/test loaders an unlearning CLI call with
    ``argv`` builds (on the CPU; the model built alongside is dropped)."""
    from salun_torch.cli.args import parse_args
    from salun_torch.cli.setup import (build_unlearn_loaders,
                                       setup_model_dataset)

    args = parse_args(argv)
    _, train, val, test, marked = setup_model_dataset(args, "cpu", 0)
    return build_unlearn_loaders(args, train, val, test, marked)


def main_path(device, kernel_ms: float) -> dict:
    import torch

    from salun_torch.ckpt import load_mask
    from salun_torch.cli import generate_mask, main_random
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
    check_pinned(mask, model_path, out_dir / "RL_checkpoint.pt", "RL")

    # one K1 launch per optimizer step
    loaders, forget, retain = unlearn_loaders(rl_args)
    steps = EPOCHS * (len(loaders["forget"]) + len(loaders["retain"]))
    if launches["K1 masked_sgd_update"] != steps:
        fail(f"K1 launched {launches['K1 masked_sgd_update']} times for "
             f"{steps} optimizer steps")
    log(f"K1 launches {launches['K1 masked_sgd_update']} = optimizer steps")

    check_metrics(results, "RL")
    mia = results["SVC_MIA_forget_efficacy"]
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


# ----------------------------------------------------------------- phase 4b


def write_cifar100_files(data_dir: Path, train, test) -> None:
    """``train`` and ``test`` in CIFAR-100's python-pickle format
    (``cifar-100-python/{train,test}``, fine and coarse labels)."""
    base = data_dir / "cifar-100-python"
    base.mkdir(parents=True, exist_ok=True)
    for name, ds in (("train", train), ("test", test)):
        rows = ds.data.transpose(0, 3, 1, 2).reshape(len(ds), -1)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rows, b"fine_labels": ds.targets.tolist(),
                         b"coarse_labels": (ds.targets // 5).tolist()}, f)


def _unlearn_call(cli, argv, what: str) -> tuple:
    """One unlearning CLI call with K1's count set to 0 just before it and
    read just after; returns ``(results, launches)``."""
    import torch

    from salun_torch.kernels.masked_update import masked_sgd_update

    masked_sgd_update.launches = 0
    t0 = time.perf_counter()
    results = cli.main(argv)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t0
    launches = masked_sgd_update.launches
    check_metrics(results, what)
    sec = results["seconds"]
    log(f"{what}: UA {results['UA']:.2f} RA {results['retain']:.2f} "
        f"TA {results['test']:.2f} MIA "
        f"{json.dumps(results['SVC_MIA_forget_efficacy'])}; seconds: "
        f"whole CLI call {t_call:.3f}, unlearn {sec['unlearn']:.3f}, "
        f"UA/RA/TA {sec['accuracy']:.3f}, SVC-MIA {sec['mia']:.3f}; "
        f"K1 launches {launches}")
    return results, launches


def _expect_launches(what: str, launches: int, steps: int,
                     results: dict, kernel_ms: float) -> None:
    if launches != steps:
        fail(f"{what}: K1 launched {launches} times for {steps} "
             f"optimizer steps")
    if steps:
        sec = results["seconds"]["unlearn"]
        log(f"{what}: K1 launches {launches} = optimizer steps; "
            f"{1e3 * sec / steps:.3f} ms/step cold (set-up included), K1 "
            f"{kernel_ms * launches:.3f} ms of it at the phase-3 time")


def methods_paths(device, kernel_ms: float) -> dict:
    """GA, GA_l1, FT and FT_l1 with phase 4's 0.5 mask, then main_forget's
    FT and retrain, on phase 4's data and ResNet-18; returns K1's launches
    per path."""
    from salun_torch.ckpt import load_mask
    from salun_torch.cli import main_forget, main_random

    data_dir, model_path = WORK / "data", WORK / "resnet18_seed0.pt"
    mask_file = WORK / "out" / "with_0.5.pt"
    mask = load_mask(str(mask_file))
    common = ["--dataset", "cifar10", "--data", str(data_dir),
              "--arch", "resnet18", "--model_path", str(model_path),
              "--batch_size", str(BATCH), "--num_indexes_to_replace",
              str(N_FORGET), "--class_to_replace", "-1",
              "--device", str(device), "--unlearn_lr", str(LR),
              "--unlearn_epochs", str(EPOCHS)]
    loaders, _, _ = unlearn_loaders(common)
    by_path = {}
    for method, loader in (("GA", "forget"), ("GA_l1", "forget"),
                           ("FT", "retain"), ("FT_l1", "retain")):
        out_dir = WORK / "methods"
        argv = common + ["--unlearn", method, "--mask_path", str(mask_file),
                         "--save_dir", str(out_dir)]
        what = f"main_random --unlearn {method}"
        results, launches = _unlearn_call(main_random, argv, what)
        check_pinned(mask, model_path, out_dir / f"{method}_checkpoint.pt",
                     what)
        _expect_launches(what, launches, EPOCHS * len(loaders[loader]),
                         results, kernel_ms)
        by_path[what] = {K1_NAME: launches}
    for method in ("FT", "retrain"):
        argv = common + ["--unlearn", method,
                         "--save_dir", str(WORK / "forget")]
        what = f"main_forget --unlearn {method}"
        results, launches = _unlearn_call(main_forget, argv, what)
        _expect_launches(what, launches, 0, results, kernel_ms)
        by_path[what] = {K1_NAME: launches}
    return by_path


def train_resume_path(device) -> dict:
    """``main_train`` on ResNet-18 for TRAIN_EPOCHS epochs straight, then
    one epoch and ``--resume`` to TRAIN_EPOCHS in a fresh directory, with
    cuDNN deterministic for these calls: the resumed checkpoint must equal
    the straight run's bitwise. Returns K1's launches (none: plain SGD)."""
    import torch

    from salun_torch.cli import main_train
    from salun_torch.kernels.masked_update import masked_sgd_update

    common = ["--dataset", "cifar10", "--data", str(WORK / "data"),
              "--arch", "resnet18", "--batch_size", str(BATCH),
              "--lr", "0.1", "--device", str(device)]
    straight, resumed = WORK / "train_straight", WORK / "train_resumed"
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        masked_sgd_update.launches = 0
        out = main_train.main(common + ["--epochs", str(TRAIN_EPOCHS),
                                        "--save_dir", str(straight)])
        main_train.main(common + ["--epochs", "1",
                                  "--save_dir", str(resumed)])
        main_train.main(common + ["--epochs", str(TRAIN_EPOCHS), "--resume",
                                  "--save_dir", str(resumed)])
        torch.cuda.synchronize()
        launches = masked_sgd_update.launches
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was
    a, b = (torch.load(d / "checkpoint.pt", map_location="cpu",
                       weights_only=True) for d in (straight, resumed))
    if a["epoch"] != TRAIN_EPOCHS or b["epoch"] != TRAIN_EPOCHS:
        fail(f"main_train ended at epochs {a['epoch']} and {b['epoch']}")
    same = [torch.equal(v, b["state_dict"][k])
            for k, v in a["state_dict"].items()]
    same.append(torch.equal(a["momentum"], b["momentum"]))
    if not all(same) or a["count"] != b["count"]:
        fail(f"main_train --resume differs from the straight run in "
             f"{same.count(False)} of {len(same)} tensors")
    if not all(math.isfinite(v) for c in a["curves"].values() for v in c):
        fail(f"main_train curves not finite: {a['curves']}")
    if launches != 0:
        fail(f"main_train launched K1 {launches} times")
    secs = out["epoch_seconds"]
    log(f"main_train --resume: bitwise equal to {TRAIN_EPOCHS} epochs "
        f"straight ({len(same)} tensors, cuDNN deterministic); curves "
        f"{json.dumps(a['curves'])}")
    log(f"main_train seconds per epoch {[round(x, 3) for x in secs]} "
        f"({out['images_per_epoch']} images, "
        f"{[round(out['images_per_epoch'] / x, 1) for x in secs]} img/s; "
        f"the first epoch cold)")
    return {"main_train": {K1_NAME: launches}}


def cifar100_arch_paths(device, k1_rows: dict) -> dict:
    """vgg16_bn and ResNet-50 (CIFAR stem) at full width on synthetic
    CIFAR-100 files: ``generate_mask``, then ``main_random --unlearn RL``
    with the 0.5 mask (CIFAR-100's relabel-and-concat regime). Returns
    K1's launches per path, keyed by the arch's K1 row."""
    import torch

    from salun_torch.ckpt import load_mask
    from salun_torch.cli import generate_mask, main_random
    from salun_torch.data.datasets import synthetic
    from salun_torch.models import create_model

    work = WORK / "cifar100"
    data_dir = work / "data"
    write_cifar100_files(
        data_dir, synthetic(n=N_TRAIN, num_classes=100, seed=3),
        synthetic(n=N_TEST, num_classes=100, seed=4))
    by_path = {}
    for arch, n_want in (("vgg16_bn", N_VGG16_BN),
                         ("resnet50", N_RESNET50)):
        row = f"{K1_NAME} {arch}"
        model_path, out_dir = work / f"{arch}_seed0.pt", work / arch
        model = create_model(arch, 100, seed=0)
        n_model = sum(p.numel() for p in model.parameters())
        torch.save({"state_dict": model.state_dict()}, model_path)
        del model
        common = ["--dataset", "cifar100", "--data", str(data_dir),
                  "--arch", arch, "--model_path", str(model_path),
                  "--save_dir", str(out_dir), "--batch_size", str(BATCH),
                  "--num_indexes_to_replace", str(N_FORGET),
                  "--class_to_replace", "-1", "--device", str(device)]
        t0 = time.perf_counter()
        generate_mask.main(common)
        t_mask = time.perf_counter() - t0
        mask_file = out_dir / "with_0.5.pt"
        mask = load_mask(str(mask_file))
        n_mask = sum(v.numel() for v in mask.values())
        ones = int(sum(int(v.sum()) for v in mask.values()))
        if not n_mask == n_model == n_want or ones != n_want // 2:
            fail(f"{arch}: 0.5 mask has {ones} ones of {n_mask}; the model "
                 f"has {n_model} parameters, want {n_want}")
        log(f"{arch}, 100 classes: {n_model} parameters; mask 0.5 exactly "
            f"{ones} ones; generate_mask {t_mask:.3f} s (whole CLI call)")
        argv = common + ["--unlearn", "RL", "--mask_path", str(mask_file),
                         "--unlearn_lr", str(LR),
                         "--unlearn_epochs", str(EPOCHS)]
        what = f"{arch} main_random --unlearn RL"
        results, launches = _unlearn_call(main_random, argv, what)
        check_pinned(mask, model_path, out_dir / "RL_checkpoint.pt", what)
        loaders, forget, retain = unlearn_loaders(argv)
        # one relabelled forget ∪ retain loader an epoch (RL.py:51-59)
        steps = EPOCHS * -(-(len(forget) + len(retain)) // BATCH)
        _expect_launches(what, launches, steps, results, k1_rows[row])
        sec = results["seconds"]["unlearn"]
        log(f"{what}: {EPOCHS * (len(forget) + len(retain)) / sec:.1f} "
            f"img/s cold")
        by_path[what] = {row: launches}
    return by_path


# ----------------------------------------------------------------- phase 4c

# (method, CLI, epochs): the ten methods of the slice on phase 4's data,
# ResNet-18 and 0.5 mask; main_random where the method reads the mask
REMAINING = [("boundary_shrink", "main_random", EPOCHS),
             ("boundary_expanding", "main_random", EPOCHS),
             ("FT_prune", "main_random", EPOCHS),
             ("wfisher", "main_random", EPOCHS),
             ("fisher", "main_forget", EPOCHS),
             ("fisher_new", "main_forget", EPOCHS),
             ("RL_proximal", "main_forget", EPOCHS),
             ("FT_prune_bi", "main_forget", PRUNE_BI_EPOCHS),
             ("GA_prune_bi", "main_forget", PRUNE_BI_EPOCHS),
             ("GA_prune", "main_forget", EPOCHS)]


def kth_on_card(device) -> None:
    """The exact k-th value on the card equals ``torch.sort``'s, bitwise,
    at the ResNet-18 N, for k = 1, ⌈N/2⌉, N and a tensor k, on normals and
    on a tensor with planted ties (a 16-level grid)."""
    import torch

    from salun_torch.dist.topk import kth_largest

    gen = torch.Generator(device=device).manual_seed(5)
    n = N_K1
    for what, x in (
            ("normal", torch.randn(n, generator=gen, device=device)),
            ("ties", torch.randint(0, 16, (n,), generator=gen,
                                   device=device).float() / 16)):
        ordered = torch.sort(x, descending=True).values
        for k in (1, -(-n // 2), n):
            for kk in (k, torch.tensor(k, device=device)):
                got = kth_largest(x, kk)
                if not torch.equal(got.reshape(1), ordered[k - 1:k]):
                    fail(f"kth_largest({what}, {k}) = {float(got)}, "
                         f"torch.sort gives {float(ordered[k - 1])}")
        ms = cuda_time_ms(lambda: kth_largest(x, n // 2), 20, warmup=2)
        log(f"kth_largest on the card equals torch.sort's k-th value "
            f"bitwise at N = {n} ({what}; k = 1, N/2, N, int and tensor); "
            f"{ms:.3f} ms a call")


def _cut_retain(n_keep: int):
    """``main_random``'s loader factory with the retain loader cut to its
    first ``n_keep`` images (the fisher calls' cut), as a context."""
    import contextlib

    import numpy as np

    import salun_torch.cli.main_random as cli
    from salun_torch.data.loader import BatchIterator

    orig = cli.build_unlearn_loaders

    def cut(args, *rest):
        loaders, forget, retain = orig(args, *rest)
        retain = retain.select(np.arange(min(n_keep, len(retain))))
        loaders["retain"] = BatchIterator(retain, args.batch_size,
                                          shuffle=True, seed=args.seed)
        return loaders, forget, retain

    @contextlib.contextmanager
    def ctx():
        cli.build_unlearn_loaders = cut
        try:
            yield
        finally:
            cli.build_unlearn_loaders = orig

    return ctx()


def _conv_zeros(sd: dict) -> tuple:
    conv = [v for v in sd.values() if v.dim() == 4]
    return (sum(int((v == 0).sum()) for v in conv),
            sum(v.numel() for v in conv))


def remaining_methods_paths(device, k1_rows: dict) -> dict:
    """The ten methods of this slice through the CLIs on phase 4's data,
    ResNet-18 and 0.5 mask, each CLI call counted on its own; returns
    K1's launches per call (boundary_expanding's on the widened model's
    row)."""
    import torch

    from salun_torch.ckpt import load_mask, load_state_dict
    from salun_torch.cli import main_forget, main_random
    from salun_torch.core.methods import UnlearnConfig
    from salun_torch.core.methods.prune_variants import _bi_round_rate
    from salun_torch.core.methods.rl_proximal import proximal_ratio

    data_dir, model_path = WORK / "data", WORK / "resnet18_seed0.pt"
    mask_file = WORK / "out" / "with_0.5.pt"
    mask = load_mask(str(mask_file))
    theta0 = load_state_dict(str(model_path))
    out_dir = WORK / "remaining"
    common = ["--dataset", "cifar10", "--data", str(data_dir),
              "--arch", "resnet18", "--model_path", str(model_path),
              "--batch_size", str(BATCH), "--num_indexes_to_replace",
              str(N_FORGET), "--class_to_replace", "-1",
              "--device", str(device), "--unlearn_lr", str(LR),
              "--save_dir", str(out_dir)]
    loaders, _, _ = unlearn_loaders(common)
    n_f, n_r = len(loaders["forget"]), len(loaders["retain"])
    log(f"phase 4c cuts: 1 epoch each (of 10), FT_prune_bi and "
        f"GA_prune_bi {PRUNE_BI_EPOCHS} (one prune round); fisher and "
        f"fisher_new over the first {FISHER_RETAIN} retain images (of "
        f"{len(loaders['retain'].ds)})")
    cfg = UnlearnConfig()
    by_path = {}
    for method, cli_name, epochs in REMAINING:
        cli = main_random if cli_name == "main_random" else main_forget
        argv = common + ["--unlearn", method,
                         "--unlearn_epochs", str(epochs)]
        if cli is main_random:
            argv += ["--mask_path", str(mask_file)]
        what = f"{cli_name} --unlearn {method}"
        if method.startswith("fisher"):
            with _cut_retain(FISHER_RETAIN):
                results, launches = _unlearn_call(cli, argv, what)
            batches = -(-FISHER_RETAIN // BATCH)
            sec = results["seconds"]["unlearn"]
            log(f"{what}: {1e3 * sec / batches:.3f} ms per retain batch of "
                f"{BATCH} ({batches} batches, cold)")
        else:
            results, launches = _unlearn_call(cli, argv, what)
        sd = load_state_dict(str(out_dir / f"{method}_checkpoint.pt"))
        if not all(bool(torch.isfinite(v).all()) for v in sd.values()
                   if v.is_floating_point()):
            fail(f"{what}: a non-finite weight")
        steps = {"boundary_shrink": n_f, "boundary_expanding": n_f,
                 "FT_prune": n_r}.get(method, 0) * epochs
        row = K1_NAME
        if method == "boundary_expanding":
            row = f"{K1_NAME} boundary_expanding"
            n_wide = sum(sd[k].numel() for k in mask)
            if n_wide != N_K1_WIDE:
                fail(f"{what}: the widened model has {n_wide} parameters, "
                     f"want {N_K1_WIDE}")
        _expect_launches(what, launches, steps, results, k1_rows[row])
        by_path[what] = {row: launches}
        if cli is main_random:
            check_pinned(mask, model_path,
                         out_dir / f"{method}_checkpoint.pt", what)
        if method == "RL_proximal":
            n = sum(v.numel() for v in mask.values())
            total = epochs * (n_f + n_r)
            want = proximal_ratio(cfg, n, total, (epochs - 1) * (n_f + n_r))
            pinned = sum(int((sd[k] == theta0[k]).sum()) for k in mask)
            if pinned < want:
                fail(f"{what}: {pinned} weights at θ_init, want >= {want}")
            log(f"{what}: {pinned} of {n} weights at θ_init (>= the last "
                f"step's ratio {want})")
        if method in ("FT_prune", "FT_prune_bi", "GA_prune_bi", "GA_prune"):
            zeros, n_conv = _conv_zeros(sd)
            if method == "FT_prune":
                log(f"{what}: natural conv sparsity "
                    f"{100 * zeros / n_conv:.4f}%")
                continue
            c = UnlearnConfig(unlearn_epochs=epochs)
            px = 1.0 - c.rate if method == "GA_prune" else _bi_round_rate(c)
            if zeros != round(px * n_conv):
                fail(f"{what}: {zeros} zero conv weights, want "
                     f"round({px} x {n_conv}) = {round(px * n_conv)}")
            log(f"{what}: exactly {zeros} of {n_conv} conv weights pruned")
    return by_path


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


# ----------------------------------------------------------------- phase 5b


def _attention_kernels():
    from salun_torch.kernels import flash_attention as fa

    return {"K2 flash_attention_fwd": fa.flash_attention_fwd,
            "K3a flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "K3b flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


class D512Counter:
    """Counts K3a's and K3b's launches at D = 512 (the STL-10 mid block),
    in the wrappers' launch helper; their own ``.launches`` go on counting
    all."""

    def __init__(self):
        from salun_torch.kernels import flash_attention as fa

        self.fa, self.launch = fa, fa._launch
        self.counts = dict.fromkeys(D512_ROWS.values(), 0)

    def __enter__(self):
        def launch(fn, name, q, *args):
            if name in D512_ROWS and q.shape[-1] == 512:
                self.counts[D512_ROWS[name]] += 1
            return self.launch(fn, name, q, *args)

        self.fa._launch = launch
        return self

    def __exit__(self, *exc):
        self.fa._launch = self.launch


def _counted(what: str, want: list, fn, d512=None):
    """``fn()`` with the attention kernels' counts set to 0 just before and
    read just after; fails unless they are ``want`` (K2, K3a, K3b).
    Returns ``(fn's result, {kernel row: launches})``."""
    import torch

    kernels = _attention_kernels()
    for f in kernels.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = [f.launches for f in kernels.values()]
    if got != want:
        fail(f"{what}: K2/K3a/K3b launches {got}, the path implies {want}")
    log(f"{what}: K2/K3a/K3b launches {got}, as the path implies")
    counts = dict(zip(kernels, got))
    if d512 is not None:
        counts.update(d512)
    return out, counts


def _finite_losses(what: str, result: dict, steps: int) -> None:
    losses = result["losses"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{what} losses {losses}")
    log(f"{what}: {steps} steps, losses finite (first {losses[0]:.4f}, "
        f"last {losses[-1]:.4f}); {result['ms_per_step']:.3f} ms/step over "
        f"steps {result['start_step'] + 2}-{result['start_step'] + steps} "
        f"(first step {result['seconds']['first_step']:.3f} s)")


def _images_ok(what: str, stats: dict, n: int) -> None:
    if not (stats["finite"] and 0.0 <= stats["min"] <= stats["max"] <= 1.0
            and stats["images"] == n):
        fail(f"{what}: {stats}")
    log(f"{what}: {n} images finite in [{stats['min']:.4f}, "
        f"{stats['max']:.4f}], {stats['seconds']:.3f} s")


def _compare_train_states(a_path: Path, b_path: Path) -> int:
    """Model, Adam state, step and EMA of two DDPM checkpoints, bitwise;
    returns the number of tensors compared."""
    import torch

    from salun_torch.ckpt import load_ddpm_train_state

    a, b = (load_ddpm_train_state(str(p)) for p in (a_path, b_path))
    if a[2] != b[2]:
        fail(f"--resume ended at step {b[2]}, the straight run at {a[2]}")
    same = [torch.equal(v, b[0][k]) for k, v in a[0].items()]
    same += [torch.equal(v, b[3][k]) for k, v in a[3].items()]
    for i, st in a[1]["state"].items():
        same += [torch.equal(torch.as_tensor(st[k]),
                             torch.as_tensor(b[1]["state"][i][k]))
                 for k in ("step", "exp_avg", "exp_avg_sq")]
    if not all(same):
        fail(f"--resume differs from the straight run in "
             f"{same.count(False)} of {len(same)} tensors")
    return len(same)


def ddpm_train_paths(device) -> dict:
    """Phase 5b, CIFAR-10: ``ddpm_train --mode train`` (EMA), ``retrain``,
    ``train`` 10 steps then ``--resume`` to 20, ``ddpm_fim``, the remember
    set by ``ddpm_sample``, ``forget``, the other sample modes and
    ``ddpm_save_base``, through the port's CLIs at the full width of
    ``configs/ddpm/cifar10_train.yml``. Returns the launches by path."""
    import torch

    from salun_torch.ckpt import load_ddpm_states, load_mask
    from salun_torch.cli import (ddpm_fim, ddpm_sample, ddpm_save_base,
                                 ddpm_train)
    from salun_torch.cli.ddpm_config import load_config
    from salun_torch.diffusion.runner import DDPMRunner
    from salun_torch.diffusion.sampling import timestep_sequence
    from salun_torch.diffusion.unet import attention_sites

    work = WORK / "ddpm_train"
    shutil.rmtree(work, ignore_errors=True)
    data_dir = work / "data"
    write_cifar10_files(data_dir, ddpm_dataset())
    bundle = load_config(str(DDPM_TRAIN_CONFIG))
    n_params = sum(p.numel() for p in DDPMRunner(
        bundle.unet, bundle.schedule, bundle.train).init(0).parameters())
    sites = attention_sites(bundle.unet)
    n = DDPM_ITERS
    steps = len(timestep_sequence(bundle.schedule.num_timesteps,
                                  DDPM_STEPS))
    log(f"DDPM train U-Net ({DDPM_TRAIN_CONFIG.name}: ch {bundle.unet.ch}, "
        f"ch_mult {bundle.unet.ch_mult}, EMA {bundle.train.ema_rate}): "
        f"{n_params} parameters, seeded random weights")
    log(f"DDPM train cuts: {10 * DDPM_PER_CLASS} training images instead of "
        f"50,000; train and retrain {n} steps (of {bundle.train.n_iters}), "
        f"resume {n // 2} + {n - n // 2}; FIM over {FIM_SAMPLES} images at "
        f"{FIM_TIMESTEPS} timesteps (of 512 and 1000), batch {FIM_BATCH}; "
        f"the SA remember set {DDPM_SAMPLES} samples of each kept class at "
        f"{DDPM_STEPS} DDIM steps; forget {n} steps (of 20,000); sampling "
        f"at {DDPM_STEPS} DDIM steps (of 1000)")
    common = ["--config", str(DDPM_TRAIN_CONFIG), "--data", str(data_dir),
              "--label_to_forget", "0", "--device", str(device),
              "--n_iters", str(n)]
    straight, resumed = work / "straight", work / "resumed"
    by_path = {}

    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        result, by_path["ddpm_train"] = _counted(
            "DDPM train (cuDNN deterministic)", [sites * n] * 3,
            lambda: ddpm_train.main(common + ["--mode", "train",
                                              "--save_dir", str(straight)]))
        _finite_losses("DDPM train", result, n)
        _, by_path["ddpm_train_resume"] = _counted(
            f"DDPM train {n // 2} + --resume {n - n // 2}", [sites * n] * 3,
            lambda: [ddpm_train.main(
                common[:-1] + [str(n // 2), "--mode", "train",
                               "--save_dir", str(resumed)]),
                ddpm_train.main(common + ["--mode", "train", "--resume",
                                          "--save_dir", str(resumed)])])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was
    compared = _compare_train_states(straight / "ckpts" / "ckpt.pth",
                                     resumed / "ckpts" / "ckpt.pth")
    log(f"DDPM train --resume: model, Adam state, step and EMA bitwise "
        f"equal to {n} steps straight ({compared} tensors, cuDNN "
        f"deterministic)")
    model_sd, _, ema_sd = load_ddpm_states(str(straight / "ckpts" /
                                               "ckpt.pth"))
    differ = sum(not torch.equal(model_sd[k], ema_sd[k]) for k in ema_sd)
    if differ == 0:
        fail("the EMA equals the parameters after training")
    log(f"DDPM train: the EMA differs from the parameters in {differ} of "
        f"{len(ema_sd)} tensors")

    result, by_path["ddpm_retrain"] = _counted(
        "DDPM retrain", [sites * n] * 3,
        lambda: ddpm_train.main(common + ["--mode", "retrain", "--save_dir",
                                          str(work / "retrain")]))
    _finite_losses("DDPM retrain", result, n)
    if 0 in result["labels_seen"] or not result["labels_seen"]:
        fail(f"retrain saw the labels {result['labels_seen']}")
    log(f"DDPM retrain saw the labels {result['labels_seen']} (never 0)")

    passes = FIM_SAMPLES // FIM_BATCH * FIM_TIMESTEPS
    fim, by_path["ddpm_fim"] = _counted(
        f"DDPM FIM ({passes} vmapped gradients of {FIM_BATCH} samples)",
        [sites * passes] * 3,
        lambda: ddpm_fim.main([
            "--config", str(DDPM_FIM_CONFIG), "--data", str(data_dir),
            "--ckpt_folder", str(straight), "--save_dir", str(straight),
            "--n_samples", str(FIM_SAMPLES), "--batch", str(FIM_BATCH),
            "--n_timestep_samples", str(FIM_TIMESTEPS),
            "--device", str(device)]))
    saved = load_mask(str(straight / "fisher.pt"))
    total = sum(float(v.sum()) for v in saved.values())
    if (len(saved) != len(model_sd) or not math.isfinite(total)
            or total <= 0 or any(float(v.min()) < 0 for v in saved.values())):
        fail(f"the FIM is not finite and non-negative (sum {total})")
    log(f"DDPM FIM seconds {fim['seconds']:.3f}: {FIM_SAMPLES} images, "
        f"{FIM_TIMESTEPS} timesteps each, sum {total:.6e}")

    kept = 9
    stats, by_path["ddpm_remember_set"] = _counted(
        "DDPM SA remember set", [sites * steps * kept, 0, 0],
        lambda: ddpm_sample.main([
            "--config", str(DDPM_SAMPLE_CONFIG), "--mode", "sample_classes",
            "--ckpt_folder", str(straight), "--classes", "x0",
            "--n_samples_per_class", str(DDPM_SAMPLES),
            "--batch", str(DDPM_SAMPLES), "--timesteps", str(DDPM_STEPS),
            "--save_dir", str(straight / "class_samples"),
            "--device", str(device)]))
    _images_ok("DDPM SA remember set", stats, DDPM_SAMPLES * kept)
    result, by_path["ddpm_forget"] = _counted(
        "DDPM forget (SA)", [2 * sites * n] * 3,
        lambda: ddpm_train.main(
            ["--config", str(DDPM_FORGET_CONFIG), "--data", str(data_dir),
             "--label_to_forget", "0", "--device", str(device),
             "--n_iters", str(n), "--mode", "forget",
             "--ckpt_folder", str(straight),
             "--save_dir", str(work / "forget")]))
    _finite_losses("DDPM forget (SA)", result, n)
    if 0 in result["labels_seen"]:
        fail(f"forget's remember set holds class 0: {result['labels_seen']}")

    sample = ["--config", str(DDPM_SAMPLE_CONFIG), "--ckpt_folder",
              str(work / "forget"), "--timesteps", str(DDPM_STEPS),
              "--device", str(device)]
    classes = len(DDPM_CLASSES)
    stats, by_path["ddpm_sample_fid"] = _counted(
        "DDPM sample_fid", [sites * steps * classes, 0, 0],
        lambda: ddpm_sample.main(sample + [
            "--mode", "sample_fid", "--classes",
            ",".join(map(str, DDPM_CLASSES)),
            "--n_samples_per_class", str(DDPM_SAMPLES),
            "--batch", str(DDPM_SAMPLES), "--save_dir",
            str(work / "sample_fid")]))
    _images_ok("DDPM sample_fid", stats, DDPM_SAMPLES * classes)
    stats, by_path["ddpm_sample_visualization"] = _counted(
        "DDPM sample_visualization", [sites * steps * 10, 0, 0],
        lambda: ddpm_sample.main(sample + [
            "--mode", "sample_visualization", "--save_dir",
            str(work / "grid")]))
    _images_ok("DDPM sample_visualization (grid.png)", stats, 100)
    stats, by_path["ddpm_sample_trajectory"] = _counted(
        "DDPM sample_trajectory", [sites * steps, 0, 0],
        lambda: ddpm_sample.main(sample + [
            "--mode", "sample_trajectory", "--save_dir",
            str(work / "trajectory")]))
    _images_ok("DDPM sample_trajectory (both chains)", stats, 10)

    t0 = time.perf_counter()
    saved = ddpm_save_base.main(["--dataset", "cifar10", "--data",
                                 str(data_dir), "--label_to_forget", "0",
                                 "--save_dir", str(work / "base_set")])
    folders = sorted(p.name for p in (work / "base_set").iterdir())
    if saved != 9 * DDPM_PER_CLASS or "0" in folders:
        fail(f"ddpm_save_base wrote {saved} images into {folders}")
    log(f"ddpm_save_base: {saved} PNGs in {folders} "
        f"({time.perf_counter() - t0:.3f} s)")
    # phase 5c reads the data and the sample_fid folder, then removes work
    return by_path


def write_stl10_files(data_dir: Path, ds) -> None:
    """``ds`` (96x96 NHWC) in STL-10's binary layout: ``train_X.bin`` with
    each image CHW and every channel column-major, ``train_y.bin`` with
    labels 1..10."""
    import numpy as np

    base = data_dir / "stl10_binary"
    base.mkdir(parents=True, exist_ok=True)
    np.ascontiguousarray(ds.data.transpose(0, 3, 2, 1)).tofile(
        base / "train_X.bin")
    (ds.targets + 1).astype(np.uint8).tofile(base / "train_y.bin")


def stl10_path(device) -> dict:
    """Phase 5b, STL-10: ``train`` 20 steps, ``generate_mask`` and 2 classes
    × 16 samples at the full width of ``configs/ddpm/stl10_train.yml``
    (64x64, ch_mult [1, 2, 2, 2, 4]: the mid block's attention at D = 512)
    on synthetic STL-10 binary files at 96x96. Returns the launches by
    path, K3a's and K3b's at D = 512 apart."""
    import numpy as np

    from salun_torch.cli import ddpm_sample, ddpm_train
    from salun_torch.cli.ddpm_config import load_config
    from salun_torch.diffusion.runner import DDPMRunner
    from salun_torch.diffusion.sampling import timestep_sequence
    from salun_torch.diffusion.unet import attention_sites

    work = WORK / "stl10"
    shutil.rmtree(work, ignore_errors=True)
    pool = ddpm_dataset()  # 500 of each class, 32x32
    pool.data = np.repeat(np.repeat(pool.data, 3, axis=1), 3, axis=2)
    write_stl10_files(work / "data", pool)
    bundle = load_config(str(STL10_CONFIG))
    n_params = sum(p.numel() for p in DDPMRunner(
        bundle.unet, bundle.schedule, bundle.train).init(0).parameters())
    sites = attention_sites(bundle.unet)
    n, bs = DDPM_ITERS, bundle.train.batch_size
    steps = len(timestep_sequence(bundle.schedule.num_timesteps,
                                  DDPM_STEPS))
    log(f"STL-10 U-Net ({STL10_CONFIG.name}: {bundle.unet.image_size}x"
        f"{bundle.unet.image_size}, ch {bundle.unet.ch}, ch_mult "
        f"{bundle.unet.ch_mult}): {n_params} parameters, seeded random "
        f"weights; {sites} attention sites, the mid block's at D = "
        f"{bundle.unet.ch * bundle.unet.ch_mult[-1]}")
    log(f"STL-10 cuts: {len(pool)} synthetic 96x96 images (phase 5's, "
        f"upsampled 3x; STL-10's train split is 5,000) resized to 64; train "
        f"{n} steps (of {bundle.train.n_iters}); mask over class 0; "
        f"{DDPM_SAMPLES} samples of {len(DDPM_CLASSES)} classes at "
        f"{DDPM_STEPS} DDIM steps")
    common = ["--config", str(STL10_CONFIG), "--data", str(work / "data"),
              "--label_to_forget", "0", "--device", str(device)]
    by_path = {}
    with D512Counter() as d512:
        result, by_path["stl10_train"] = _counted(
            "STL-10 train", [sites * n] * 3,
            lambda: ddpm_train.main(common + [
                "--mode", "train", "--n_iters", str(n),
                "--save_dir", str(work / "base")]),
            d512.counts)
    _finite_losses("STL-10 train", result, n)
    if list(d512.counts.values()) != [n, n]:
        fail(f"STL-10 train: K3a/K3b at D = 512 {d512.counts}, want {n}")
    batches = -(-DDPM_PER_CLASS // bs)
    with D512Counter() as d512:
        _, by_path["stl10_mask"] = _counted(
            "STL-10 generate_mask", [sites * batches] * 3,
            lambda: ddpm_train.main(common + [
                "--mode", "generate_mask", "--ckpt_folder",
                str(work / "base"), "--save_dir", str(work / "mask")]),
            d512.counts)
    if list(d512.counts.values()) != [batches, batches]:
        fail(f"STL-10 mask: K3a/K3b at D = 512 {d512.counts}")
    log(f"STL-10 K3a/K3b launches at D = 512: train {n} each, mask "
        f"{batches} each")
    stats, by_path["stl10_sample"] = _counted(
        "STL-10 sample_fid", [sites * steps * len(DDPM_CLASSES), 0, 0],
        lambda: ddpm_sample.main([
            "--config", str(STL10_CONFIG), "--mode", "sample_fid",
            "--ckpt_folder", str(work / "base"),
            "--classes", ",".join(map(str, DDPM_CLASSES)),
            "--n_samples_per_class", str(DDPM_SAMPLES),
            "--batch", str(DDPM_SAMPLES), "--timesteps", str(DDPM_STEPS),
            "--save_dir", str(work / "samples"), "--device", str(device)]))
    _images_ok("STL-10 sample_fid", stats, DDPM_SAMPLES * len(DDPM_CLASSES))
    shutil.rmtree(work, ignore_errors=True)
    return by_path


# ----------------------------------------------------------------- phase 5c


def ddpm_eval_path(device) -> None:
    """Phase 5c: the port's InceptionV3 on the card against the CPU (TF32
    off), its feature rate, a set's FID against itself, ``ddpm_evaluator``
    over phase 5b's ``sample_fid`` folder against synthetic CIFAR PNGs, and
    ``ddpm_classifier`` ``train`` (also ``--freeze_layers``) and ``eval``
    at 224 px on phase 5b's CIFAR files and samples. No port kernel runs
    here (neither network has attention or GroupNorm)."""
    import csv

    import numpy as np
    import torch

    from salun_torch.cli import ddpm_classifier, ddpm_evaluator
    from salun_torch.cli.ddpm_sample import write_png
    from salun_torch.evalx.fid import FIDStatistics
    from salun_torch.evalx.inception import build_inception, make_feature_fn
    from salun_torch.models import create_model
    from salun_torch.utils.device import set_tf32

    work = WORK / "ddpm_train"
    samples, data_dir = work / "sample_fid", work / "data"
    pool = ddpm_dataset()
    set_tf32(False)
    card = build_inception(None, device, seed=0)
    cpu = build_inception(None, "cpu", seed=0)
    imgs = pool.data[:INCEPTION_CHECK].astype(np.float32) / 255.0
    got = make_feature_fn(card, INCEPTION_CHECK)(imgs)
    want = make_feature_fn(cpu, INCEPTION_CHECK)(imgs)
    del cpu
    for name, g, w in zip(("pool", "spatial", "softmax"), got, want):
        err, ref = float(np.abs(g - w).max()), float(np.abs(w).max())
        if g.shape != w.shape or not err <= INCEPTION_TOL * max(1.0, ref):
            fail(f"Inception {name} on the card differs from the CPU's: "
                 f"shape {g.shape}, max abs err {err}")
        log(f"Inception {name} {list(g.shape)}: card vs CPU max abs err "
            f"{err:.3e} (max|CPU| {ref:.3e}, TF32 off)")
    if not np.allclose(got[2].sum(1), 1.0, atol=1e-5):
        fail("Inception softmax rows do not sum to 1")

    extract = make_feature_fn(card, 64)
    timed = pool.data[:FID_TIMED].astype(np.float32) / 255.0
    extract(timed[:64])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract(timed)
    seconds = time.perf_counter() - t0
    log(f"Inception features: {FID_TIMED} images of 32x32 at batch 64 in "
        f"{seconds:.3f} s, {FID_TIMED / seconds:.1f} images/s (resize to "
        f"299, fp32, TF32 off)")
    stats = FIDStatistics.from_activations(feats[0].astype(np.float64))
    trace = float(np.trace(stats.sigma))
    t0 = time.perf_counter()
    self_fid = stats.frechet_distance(stats)
    if not abs(self_fid) <= FID_SELF_TOL * max(1.0, trace):
        fail(f"FID of {FID_TIMED} images against themselves {self_fid} "
             f"(tr Σ {trace})")
    log(f"FID of {FID_TIMED} images against themselves {self_fid:.3e} (tr Σ "
        f"{trace:.3e}; the host's sqrtm at 2,048 dims "
        f"{time.perf_counter() - t0:.3f} s)")
    del feats, timed

    ref = work / "fid_ref"
    ref.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(pool.data[-FID_REF:]):
        write_png(str(ref / f"{i}.png"), img)
    out_csv = work / "fid" / "result.csv"
    t0 = time.perf_counter()
    results = ddpm_evaluator.main([str(ref), str(samples), "--output_csv",
                                   str(out_csv), "--device", str(device)])
    rows = list(csv.reader(open(out_csv)))
    if (not all(map(math.isfinite, results.values())) or len(rows) != 2
            or rows[0] != ["ref", "sample"] + list(results)):
        fail(f"ddpm_evaluator: {results}, CSV rows {rows}")
    log(f"ddpm_evaluator ({FID_REF} synthetic CIFAR PNGs against phase 5b's "
        f"{DDPM_SAMPLES * len(DDPM_CLASSES)} samples, random-init "
        f"Inception): {results}; the CSV row written "
        f"({time.perf_counter() - t0:.3f} s)")

    common = ["--dataset", "cifar10", "--data", str(data_dir), "--limit",
              str(CLS_LIMIT), "--batch_size", str(CLS_BS), "--epochs", "1",
              "--device", str(device)]
    trained = ddpm_classifier.main(["train", *common, "--save_dir",
                                    str(work / "classifier")])
    frozen = ddpm_classifier.main(["train", *common, "--freeze_layers",
                                   "--save_dir", str(work / "frozen")])
    init = create_model("resnet34", 10, seed=1).state_dict()
    saved = torch.load(frozen["path"], map_location="cpu",
                       weights_only=True)["state_dict"]
    body = [k for k in init if not k.startswith("fc.")
            and k.endswith(("weight", "bias"))]
    if not all(torch.equal(saved[k], init[k]) for k in body):
        fail("ddpm_classifier --freeze_layers moved a body weight")
    if torch.equal(saved["fc.weight"], init["fc.weight"]):
        fail("ddpm_classifier --freeze_layers did not train the head")
    log(f"ddpm_classifier train (ResNet-34 at 224, bs {CLS_BS}, "
        f"{trained['steps']} steps on {CLS_LIMIT} images): "
        f"{trained['ms_per_step']:.3f} ms/step over steps 2-"
        f"{trained['steps']} (first {trained['first_step_seconds']:.3f} s); "
        f"--freeze_layers {frozen['ms_per_step']:.3f} ms/step, its "
        f"{len(body)} body tensors bitwise the seeded init")
    ev = ddpm_classifier.main([
        "eval", "--sample_path", str(samples / str(DDPM_CLASSES[0])),
        "--label_of_forgotten_class", str(DDPM_CLASSES[0]), "--ckpt",
        trained["path"], "--save_dir", str(work / "classifier"),
        "--device", str(device)])
    probs = ev.pop("probs")
    if (len(probs) != DDPM_SAMPLES
            or not np.allclose(probs.sum(1), 1.0, atol=1e-5)
            or not all(map(math.isfinite, ev.values()))):
        fail(f"ddpm_classifier eval: {ev}, {len(probs)} rows")
    log(f"ddpm_classifier eval over {len(probs)} class-{DDPM_CLASSES[0]} "
        f"samples: {ev}, probabilities sum to 1")
    shutil.rmtree(work, ignore_errors=True)


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


def write_png_folder(root: Path, n: int, seed: int) -> None:
    """``n`` seeded non-square (400×320) PNGs in a flat folder."""
    import numpy as np

    from salun_torch.cli.ddpm_sample import write_png

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_png(str(root / f"{i}.png"),
                  rng.integers(0, 256, (320, 400, 3)).astype(np.uint8))


def write_imagenette_folder(root: Path) -> None:
    """``imagenette2/train/<wnid>/`` with SD_PER_CLASS non-square seeded
    PNGs per class, so the loader's resize and center crop run."""
    for c in range(10):
        write_png_folder(root / "imagenette2" / "train" / f"n{c:08d}",
                         SD_PER_CLASS, 5 + c)


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


def check_sd_pinned(before: Path, after: Path, mask, what: str,
                    device) -> None:
    """Every masked-out U-Net weight of ``after`` equals ``before``'s
    bitwise (``mask=None``: no such check), the VAE and CLIP are unchanged
    bitwise, and some U-Net weight moved."""
    import torch

    from salun_torch.ckpt import load_compvis_state_dict

    theta0 = load_compvis_state_dict(str(before))
    new_sd = load_compvis_state_dict(str(after))
    if set(theta0) != set(new_sd):
        fail(f"{what}: compvis.ckpt holds other keys than the seeded one")
    moved = 0
    prefix = "model.diffusion_model."
    for key, new in new_sd.items():
        new, old = new.to(device), theta0[key].to(device)
        if not key.startswith(prefix):
            if not torch.equal(new, old):
                fail(f"{what}: frozen SD weight {key} changed")
            continue
        if mask is not None:
            keep = mask[key[len(prefix):]] > 0
            if not torch.equal(new[~keep], old[~keep]):
                fail(f"{what}: SD {key}: a masked-out weight left θ₀")
        moved += int((new != old).sum())
    if moved == 0:
        fail(f"{what} moved no U-Net weight")
    log(f"after {what}: "
        + ("every masked-out U-Net weight equals θ₀ bitwise, " if mask
           is not None else "")
        + f"the VAE and CLIP are unchanged bitwise; {moved} U-Net weights "
          f"moved")


def _sd_kernels() -> dict:
    """The wrappers the SD paths launch, by kernel-table name."""
    from salun_torch.kernels import flash_attention as fa
    from salun_torch.kernels import groupnorm_silu as gn
    from salun_torch.kernels.masked_update import masked_sgd_update

    return {"K1 masked_sgd_update": masked_sgd_update,
            "K2 flash_attention_fwd": fa.flash_attention_fwd,
            "K3a flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "K3b flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "K4 groupnorm_silu": gn.groupnorm_silu,
            "K4b groupnorm_silu_backward": gn.groupnorm_silu_backward}


def sd_path(device, attn_rows) -> dict:
    """The SD SalUn chain through the port's three CLIs, then phase 6b on
    its checkpoint and data; returns the launch counts by path (``sd``:
    the chain's)."""
    import gc
    import os

    import torch

    from salun_torch.ckpt import load_sd_mask
    from salun_torch.cli import sd_generate_images, sd_train
    from salun_torch.diffusion.sampling import ldm_uniform_timesteps
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

    kernels = _sd_kernels()

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

    check_sd_pinned(ckpt, work / "rl" / "compvis.ckpt", mask, "random_label",
                    device)
    del mask

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
    rest = sd_rest_paths(device, work, ckpt, mask_file, cfg,
                         result["losses"])
    shutil.rmtree(work, ignore_errors=True)
    return {"sd": total, **rest}


def sd_rest_paths(device, work: Path, ckpt: Path, mask_file: Path, cfg,
                  rl_losses) -> dict:
    """Phase 6b: ``gradient_ascent``, ``nsfw_removal`` and ``proximal``
    with phase 6's 0.5 mask, ``esd``, and ``random_label
    --cache_vae_moments`` through ``salun_torch.cli.sd_train`` on phase
    6's checkpoint and data, each with its launch count and gates. Returns
    the launches by path."""
    import gc

    import torch

    from salun_torch.ckpt import load_compvis_state_dict, load_sd_mask
    from salun_torch.cli import sd_train
    from salun_torch.diffusion.sampling import ldm_uniform_timesteps
    from salun_torch.dist.topk import kth_largest
    from salun_torch.sd.trainers import proximal_ratio
    from salun_torch.sd.unet import kernel_sites

    kernels = _sd_kernels()
    names = list(kernels)
    unet = kernel_sites(cfg.unet)
    enc = 2 * len(cfg.vae.ch_mult) * cfg.vae.num_res_blocks + 5
    k2f, k4f, k2r, k4r = (unet["k2"], unet["k4"], unet["k2_remat"],
                          unet["k4_remat"])
    steps = SD_PER_CLASS // SD_BS
    nsfw_steps = SD_NSFW_IMAGES // SD_BS
    write_png_folder(work / "nsfw", SD_NSFW_IMAGES, 8)
    write_png_folder(work / "not-nsfw", SD_NSFW_IMAGES, 9)
    log(f"SD phase 6b cuts: gradient_ascent, proximal and random_label "
        f"--cache_vae_moments 1 epoch ({steps} steps at bs {SD_BS}, of 5 "
        f"epochs); nsfw_removal {nsfw_steps} steps over {SD_NSFW_IMAGES} + "
        f"{SD_NSFW_IMAGES} synthetic PNGs; esd {SD_ESD_ITERS} iterations "
        f"(of 1,000) at {SD_STEPS} DDIM steps; proximal --mask_ratio "
        f"{SD_PROX_RATIO} (the default 0.5's ratio lands in the 0.5 mask's "
        f"zeros, τ = 0)")

    def want(k2, k3, k4, k4b):
        return dict(zip(names, (0, k2, k3, k3, k4, k4b)))

    # a random_label step: 3 VAE encodes, 3 U-Net forwards (2 with the
    # remat recompute), 2 backwards; cached, 1 encode (the remain side)
    rl_step = (3 + 3 * k2f + 2 * k2r, 2 * k2f, 3 * enc + 3 * k4f + 2 * k4r,
               2 * k4f)

    def counted(what, fn, expect):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in kernels.items()}
        if callable(expect):
            expect = expect(out)
        if got != expect:
            fail(f"{what}: launches {got}, the path implies {expect}")
        log(f"{what}: launches {got}, as the path implies")
        gc.collect()
        torch.cuda.empty_cache()
        return out, got

    common = ["--config", str(SD_CONFIG), "--ckpt_path", str(ckpt),
              "--data", str(work / "data"), "--image_size", str(SD_IMAGE),
              "--batch_size", str(SD_BS), "--lr", str(SD_LR), "--alpha",
              str(SD_ALPHA), "--train_method", "full", "--remat",
              "--device", str(device)]
    masked = common + ["--mask_path", str(mask_file)]
    mask = load_sd_mask(str(mask_file), device)
    by_path = {}

    def report(what, result, n):
        losses = result["losses"]
        if len(losses) != n or not all(map(math.isfinite, losses)):
            fail(f"{what} losses {losses}")
        log(f"{what}: {n} steps, losses finite {[round(x, 5) for x in losses]}"
            f"; {result['ms_per_step']:.3f} ms/step over steps 2-{n} (first "
            f"step {result['seconds']['first_step']:.3f} s)")

    result, by_path["sd_gradient_ascent"] = counted(
        "SD gradient_ascent", lambda: sd_train.main([
            "gradient_ascent", *masked, "--epochs", "1", "--save_dir",
            str(work / "ga")]),
        want(steps * 2 * (1 + k2f + k2r), steps * 2 * k2f,
             steps * 2 * (enc + k4f + k4r), steps * 2 * k4f))
    report("SD gradient_ascent", result, steps)
    check_sd_pinned(ckpt, work / "ga" / "compvis.ckpt", mask,
                    "gradient_ascent", device)

    result, by_path["sd_nsfw_removal"] = counted(
        "SD nsfw_removal", lambda: sd_train.main([
            "nsfw_removal", *masked, "--forget_dir", str(work / "nsfw"),
            "--remain_dir", str(work / "not-nsfw"), "--save_dir",
            str(work / "nsfw_out")]),
        want(*(nsfw_steps * k for k in rl_step)))
    report("SD nsfw_removal", result, nsfw_steps)
    check_sd_pinned(ckpt, work / "nsfw_out" / "compvis.ckpt", mask,
                    "nsfw_removal", device)

    result, by_path["sd_proximal"] = counted(
        "SD proximal", lambda: sd_train.main([
            "proximal", *masked, "--epochs", "1", "--mask_ratio",
            str(SD_PROX_RATIO), "--save_dir", str(work / "prox")]),
        want(*(steps * k for k in rl_step)))
    report("SD proximal", result, steps)
    # the shrink counts of JAX's loop (sd_train.py:262-306): the whole
    # model's count, forget + remain batches an epoch, minus the frozen
    n_total, n_frozen = result["n_total"], result["n_frozen"]
    remain = 9 * SD_PER_CLASS  # the other nine classes
    ratios = [proximal_ratio(SD_PROX_RATIO, 0, i, steps, -(-remain // SD_BS),
                             1, n_total) - n_frozen for i in range(steps)]
    shrinks = result["shrinks"]
    if (not shrinks or [x["ratio"] for x in shrinks]
            != [r for r in ratios if r >= 1]
            or not all(x["pinned"] >= x["ratio"] and x["tau"] > 0
                       for x in shrinks)):
        fail(f"SD proximal shrinks {shrinks}, the schedule implies "
             f"{ratios}")
    log(f"SD proximal: {len(shrinks)} shrinks (n_total {n_total}, n_frozen "
        f"{n_frozen}): ratio, τ, weights at θ₀ after it "
        f"(ratio plus the ties at τ and the moves that round onto θ₀) "
        + "; ".join(f"{x['ratio']}, {x['tau']:.6e}, {x['pinned']} "
                    f"(+{x['pinned'] - x['ratio']})" for x in shrinks)
        + f"; peak memory {result['peak_bytes'] / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over the steps and shrinks)")
    check_sd_pinned(ckpt, work / "prox" / "compvis.ckpt", mask, "proximal",
                    device)
    # the exact k-th value at full width against torch.sort's, on the
    # final |θ − θ₀|: at the last shrink's rank (inside the pinned zeros)
    # and halfway through the values above them
    theta0 = load_compvis_state_dict(str(ckpt))
    final = load_compvis_state_dict(str(work / "prox" / "compvis.ckpt"))
    prefix = "model.diffusion_model."
    flat = torch.cat([(final[k].to(device) - theta0[k].to(device)).abs()
                      .reshape(-1) for k in final if k.startswith(prefix)])
    del final
    n = flat.numel()
    ascending = torch.sort(flat).values
    zeros = int((flat == 0).sum())
    for r in (shrinks[-1]["ratio"], (zeros + n) // 2):
        tau = kth_largest(flat, n - r + 1)
        if not torch.equal(tau, ascending[r - 1]):
            fail(f"proximal τ {float(tau)} differs from torch.sort's "
                 f"{float(ascending[r - 1])} at rank {r} of {n}")
        log(f"proximal's k-th value at rank {r} of {n} |θ − θ₀| ({zeros} of "
            f"them 0) equals torch.sort's bitwise ({float(tau):.6e})")
    del flat, ascending, tau
    gc.collect()
    torch.cuda.empty_cache()

    # ESD: the teacher is captured to check it stays bitwise θ₀
    teachers = []
    frozen_copy = sd_train.frozen_copy

    def capture(u):
        teachers.append(frozen_copy(u))
        return teachers[-1]

    seq = ldm_uniform_timesteps(cfg.timesteps, SD_STEPS)[:-1]
    step_size = cfg.timesteps // SD_STEPS

    def esd_launches(result):
        # per iteration: the CFG chain's executed steps, the teacher's two
        # forwards and the trained forward (with its remat recompute) and
        # backward; no VAE
        chain = sum(sum(1 for t in seq if t >= 1 + (te - 1) * step_size)
                    for te in result["t_enc"])
        n = SD_ESD_ITERS
        return want((chain + 3 * n) * k2f + n * k2r, n * k2f,
                    (chain + 3 * n) * k4f + n * k4r, n * k4f)

    sd_train.frozen_copy = capture
    try:
        result, by_path["sd_esd"] = counted(
            "SD esd", lambda: sd_train.main([
                "esd", *common, "--prompt", "a photo of a nude person, tench",
                "--iterations", str(SD_ESD_ITERS), "--ddim_steps",
                str(SD_STEPS), "--save_dir", str(work / "esd")]),
            esd_launches)
    finally:
        sd_train.frozen_copy = frozen_copy
    report("SD esd", result, SD_ESD_ITERS)
    log(f"SD esd t_enc {result['t_enc']} (chain steps run: 49 at 0, else "
        f"50 − t_enc)")
    [teacher] = teachers
    for k, v in teacher.state_dict().items():
        if not torch.equal(v, theta0[prefix + k].to(device)):
            fail(f"ESD's teacher {k} left θ₀")
    log("SD esd: the teacher equals the seeded U-Net bitwise")
    del teachers, teacher, theta0
    check_sd_pinned(ckpt, work / "esd" / "compvis.ckpt", None, "esd",
                    device)

    # cached random_label: the forget moments once (SD_PER_CLASS / SD_BS
    # encodes), then per step 1 VAE encode instead of 3
    batches = -(-SD_PER_CLASS // SD_BS)
    result, by_path["sd_random_label_cached"] = counted(
        "SD random_label --cache_vae_moments", lambda: sd_train.main([
            "random_label", *masked, "--epochs", "1", "--cache_vae_moments",
            "--save_dir", str(work / "cached")]),
        want(batches + steps * (1 + 3 * k2f + 2 * k2r), steps * 2 * k2f,
             batches * enc + steps * (enc + 3 * k4f + 2 * k4r),
             steps * 2 * k4f))
    report("SD random_label --cache_vae_moments", result, steps)
    got, ref = result["losses"], rl_losses[:steps]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    if not worst <= SD_CACHE_TOL:
        fail(f"cached random_label losses {got} differ from phase 6's "
             f"uncached {ref} (worst relative {worst})")
    log(f"SD random_label --cache_vae_moments: losses equal phase 6's "
        f"uncached first {steps} within {worst:.3e} relative (tolerance "
        f"{SD_CACHE_TOL}); cache precompute {result['cache_seconds']:.3f} s "
        f"for {SD_PER_CLASS} images")
    check_sd_pinned(ckpt, work / "cached" / "compvis.ckpt", mask,
                    "random_label --cache_vae_moments", device)
    return by_path


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
    kernels = [k1_vs_plain(device, name, n) for name, n in K1_ROWS]
    k1_ms = {k["name"]: k["ms"] for k in kernels}
    attn_entries, attn_ms = attention_vs_plain(device)
    kernels += attn_entries
    fim_vs_plain(device)
    gn_entries, _ = groupnorm_vs_plain(device)
    kernels += gn_entries
    sd_attn_rows = sd_attention_vs_plain(device)
    masks_card_vs_cpu(device)

    # the main paths through the CLIs (TF32 on), each counted on its own
    by_path = {"classification": main_path(device, k1_ms[K1_NAME])}
    by_path.update(methods_paths(device, k1_ms[K1_NAME]))
    by_path.update(train_resume_path(device))
    by_path.update(cifar100_arch_paths(device, k1_ms))
    kth_on_card(device)
    by_path.update(remaining_methods_paths(device, k1_ms))
    by_path["ddpm"] = ddpm_path(device, attn_ms)
    by_path.update(ddpm_train_paths(device))
    ddpm_eval_path(device)
    by_path.update(stl10_path(device))
    by_path.update(sd_path(device, sd_attn_rows))
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
