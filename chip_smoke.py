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
   the card (TF32 on), cut to 1 epoch each on phase 4's 6,000/1,000
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
     CIFAR-100 files (6,000/1,000 images, 100 classes, 500 forget):
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
   once a step of boundary_shrink, boundary_expanding (on its own
   kernel-table row, the widened model's 11,174,475 parameters checked)
   and FT_prune, never on the other seven; masked-out weights equal
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
6c. The rest of SD on phase 6's seeded checkpoint, through the port's
   API and ``salun_torch.cli.sd_eval``: ``SDModules.sample`` with
   ``sampler="plms"`` and then ``"ddim"`` (2 prompts x 1 image, 50 steps,
   guidance 7.5, 512x512, the same initial latents): PLMS walks the whole
   ldm grid (51 U-Net forwards), DDIM drops its last entry (49), so K2 and
   K4 must launch exactly two U-Net forwards' worth more on PLMS (each
   call's launches are also checked in full); images finite in [0, 1];
   the seconds of both printed. A 4-step PLMS chain through K2/K4 against
   the same chain with their plain versions in their place (TF32 off,
   cuDNN deterministic; the plain chain must launch no kernel): latents
   within 1e-5 of max(1, max|plain|).
   ``sd_eval imageclassify`` over the 4 PNGs with the prompts CSV and a
   seeded torchvision-format ResNet-50 ``.pth``, on the card and on the
   CPU: the merged CSV's columns and rows, top-1 equal; then its rate
   over 128 PNGs (those 4 shifted and mirrored by a seed) at the default
   batch 16, the call's and the network's images/s printed;
   ``compute_fid`` between two folders of 32 synthetic PNGs (finite) and
   of one against itself (≤ 1e-6 x max(1, tr Σ)); ``nudenet`` stops with
   its instructions (no package there). The diffusers export of
   random_label's U-Net written and imported back bitwise. Then on phase
   4's ResNet-18, 0.5 mask and CIFAR-shaped data: 20 steps of masked Adam
   (``build_optimizer(kind="adam")``) over RL's forget loss: masked-out
   weights θ₀ bitwise, both moments 0 there (ms/step printed); the
   6,000 arrays packed as spack and 64 random gathers of 256 records by
   the native reader (the port's ``csrc/spack.cc``, built with g++) equal
   to the arrays bitwise, GB/s against the numpy reader's;
   ``device_prefetch`` batches bitwise equal to a direct ``.to(device)``,
   and a ResNet-18 SGD step fed each way in turns (the overlap printed);
   ImageNet from a seeded ``datasets.save_to_disk`` folder (512 + 128
   non-square images, 8 of the 1,000 classes, decoded at 224):
   ``ImageNetLoader``'s validation batches through ``device_prefetch``
   equal ``imagenet()``'s arrays bitwise, then ``main_forget --dataset
   imagenet --imagenet_arch`` (ResNet-18, FT, 1 epoch, bs 64): metrics
   finite, K1 never launched.
7. Data parallel (``--dp 2``), two ranks started by ``torchrun
   --nproc_per_node 2`` sharing the one card over gloo (NCCL refuses two
   ranks on one device; the NCCL route needs a machine with two cards),
   each rank this script in ``--dp-child`` mode, one launch a phase
   running its CLI calls in turn (each ``main``'s kernel counts set to 0
   just before it and read just after), TF32 on:
   7a after phase 4, ``generate_mask`` and ``main_random --unlearn RL``
   with phase 4's argv (ResNet-18, global bs 256, 1 epoch) against phase
   4's files; 7b after phase 5, ``ddpm_train`` mask generation and 4
   ``rl`` steps (bs 128) and ``ddpm_sample`` (phase 5's call) against
   phase 5's mask and samples and a 4-step single-process run; 7c inside
   phase 6, ``sd_train random_label`` at 512x512, global batch 2, 2 steps
   (against a single-process run) and ``sd_generate_images`` (phase 6's
   rows) against phase 6's images. Gates, stated for TF32 (``DP_*``):
   masks agree on ≥ 99% of entries and stay exact-k; RL (chaotic from
   a seeded ResNet-18) within its own update of the single-process run's
   weights (L2) and 5 points of its accuracies, masked-out weights at θ₀
   bitwise; Adam's runs (DDPM, SD) within lr/10 but for 1% of the
   weights and within 2·steps·lr;
   PNGs within 1 level on average and 32 at most; both ranks'
   parameters bitwise equal (the CLIs' digests); each rank's K1/K2/K3a/K3b/K4/K4b launches what the path
   implies at half the batch; gloo on both ranks. Printed: each call's
   ms/step beside the single-process one, the all-reduce's ms a step,
   each rank's peak memory. K2/K3a/K3b are held against plain at a
   rank's DDPM shape [64, 256, 256, 256] in phase 3.
8. Sharded state, inside phase 6 right after 7c, two ranks sharing the
   card over gloo: 8a a probe of ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` on CUDA tensors and of the (2, 1) and (1, 2)
   ``DeviceMesh`` (inside 8b's launch, as its group comes up); 8b
   ``sd_train random_label --dp 2 --fsdp`` with 7c's argv (2 steps at
   global bs 2): launches as 7c's, each rank's shards as the layout rule
   says, the first step's gradients before Adam within FSDP_GRAD_TOL of
   7c's rank-0 dump, the U-Net within 7c's Adam gates of 7c's, θ₀ pinned;
   per-step all-gather and reduce-scatter ms and GB, peak memory; 8e an
   async save of the sharded U-Net and Adam state after step 1 (step 2
   runs while it writes), restored here whole (no group) and into the (1,
   2) TP layout in 8d's launch, each bitwise the state at the save (shard
   digests), seconds and GB/s; 8f ``offloaded`` Adam (3 steps over the
   U-Net, state in pinned host memory) bitwise Adam on the card, the
   peak-memory drop and ms a step; in the same launch after 8b, at
   ``make_mesh(1, 2)``, TF32 off: 8d one random_label loss and backward of
   the full-width U-Net (bs 2) tensor-parallel against rank 0's
   unsharded one (loss, gathered gradients; launches; half the heads a
   rank), 8c the exact k-th value of the 859.5M |θ − θ₀| (the --fsdp
   run's) split over the ranks, bitwise the one-card sort's, both timed.
   K2/K3a/K3b at the shapes this runs ([8, N, Nk, D]) are held against
   plain in phase 3.
9. The sequence-, expert- and pipeline-parallel layers, two ranks sharing
   the card over gloo, TF32 off: 9a, in a torchrun launch of its own
   before 7a's (a rank that crashes ends only it), the ring shift on CUDA
   tensors: ``all_to_all_single`` with split sizes must be exact on both
   ranks (the route ``salun_torch/dist/collectives.py`` sets), and what
   ``batch_isend_irecv`` does is logged; then one call in phase 7a's
   launch (``e24_work``), each layer on both ranks against its
   one-process form on rank 0 within ``E24_TOL`` of max(1, max|·|):
   9b ``ring_attention`` at the SD U-Net's level-1 self-attention at bs 2
   ([16, 4096, 40], 2048 a rank): output and dq/dk/dv; 9c ``moe_apply``
   at T 8,192, d 320, E 8, GELU experts of width 1,280, capacity
   T/(p·E)·1.25: y, aux, the router's, experts' and x's gradients (the
   tokens the sharded run drops left out of the one-process loss); 9d
   ``pipeline_apply`` of two residual-MLP stages (d 1,280, hidden 5,120,
   B 256, M 4, remat) against the stages in sequence: output and stage
   gradients; 9e one 9b forward on rank 0 inside ``maybe_profile``: the
   Chrome trace must hold a CUDA kernel event. No kernel launches on
   these paths. Printed: each side's forward + backward ms.
10. A ``{"kernels": [...]}`` line (launches per path and in all, PLMS's
   as ``sd_plms``; K1's
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
# (halved from 12,000/2,000 to leave the script room for phase 8)
N_TRAIN, N_TEST, N_FORGET = 6_000, 1_000, 500
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

# Phase 7, data parallel: two ranks under torchrun share the one card
# over gloo. K2/K3a/K3b at a rank's half of the bs-128 DDPM step. SD:
# 4 forget images at global bs 2, 2 steps (phase 8's FSDP run takes the
# same 2, with an async save between them)
ATTN_DP = [(64, 256, 256, 256)]
DP_DDPM_ITERS, DP_SD_PER_CLASS, DP_SD_BS = 4, 4, 2
DP_TIMEOUT = 600  # seconds, each torchrun launch (several calls)
# Bounds of a --dp 2 run against its single-process run, TF32 on in both
# (the CLIs' setting): cuDNN may pick other convolution algorithms at half
# the batch, which round in other places (TF32 keeps ~3 digits), and the
# ranks' gradient sum is taken in another order.
DP_MASK_AGREE = 0.99       # share of mask entries equal
# RL from phase 4's seeded (untrained) ResNet-18 with random labels is
# chaotic: on the CPU two single-process runs that differ only in their
# thread count part by 43% of the distance the weights moved in 9 steps
# (the --dp 2 run by 56%), so RL's weights are held loosely (the distance
# between the runs' updates at most DP_RL_RATIO times the update) and its
# accuracies, near chance, within DP_POINTS; the CPU tests hold a few
# steps tightly
DP_RL_RATIO = 1.0
DP_POINTS = 5.0            # max |Δ| of UA/RA/TA/val accuracy, in points
# Samples, in 8-bit levels: a TF32 chain of 50 DDIM steps at half the
# batch moves a few pixels by a few levels (the first chip run read 7
# against a first bound of 4); a sharding fault (another x_T, another
# label) moves the whole image by tens of levels on average
DP_PNG_MEAN, DP_PNG_MAX = 1.0, 32
# DDPM and SD run Adam: each step moves a weight by about lr at most, so two
# runs of n steps differ by 2·n·lr at most; beyond a tenth of lr counts
DP_ADAM_SHARE = 1e-2       # max share of weights beyond lr / 10

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

# Phase 8, sharded state: two ranks share the card over gloo. K2/K3a/K3b
# at the SD U-Net's [8, N, Nk, D]: a rank's 4 of 8 heads under TP at bs 2
# and all 8 heads of FSDP's half of bs 2 give the same shapes (level 0's
# [8, 4096, 4096 or 77, 40] are ESD's rows above)
ATTN_SD_SHARDED = [(8, 1024, 1024, 80), (8, 1024, 77, 80),
                   (8, 256, 256, 160), (8, 256, 77, 160), (8, 64, 64, 160),
                   (8, 64, 77, 160)]
# the FSDP run's gradients before Adam (its first step) against the --dp 2
# run's, TF32 on in both: each tensor's max |Δ| over its own max|g| (a
# tensor below SHARDED_NOISE of the largest entry over that largest
# entry: a gradient that is zero in exact arithmetic, float noise).
# The sum over two ranks is the same either way; what differs is what
# TF32 convolutions round where FSDP feeds them gathered weights.
FSDP_GRAD_TOL, SHARDED_NOISE = 1e-3, 1e-6
# TP (TF32 off) against one process at bs 2: the loss, relative, and each
# gradient as above (its row-parallel sums are split in two)
TP_BS, TP_LOSS_TOL, TP_GRAD_TOL = 2, 1e-5, 1e-4
OFFLOAD_STEPS = 3  # Adam steps on the full U-Net, offloaded and not
# Phase 9, the sequence-, expert- and pipeline-parallel layers: two ranks
# of phase 7a's launch share the card over gloo, TF32 off, each layer
# against its one-process form on rank 0. Ring attention at the SD
# U-Net's level-1 self-attention at bs 2 ([2 images × 8 heads, 4096, 40],
# 2048 a rank); the switch MoE at its level-1 width and feed-forward (T
# tokens, d, E experts, each a GELU MLP of width h) with capacity
# T/(p·E)·1.25; two stages of the residual MLP (d, hidden, B, M), remat
E24_RING = (16, 4096, 40)
E24_MOE = (8192, 320, 8, 1280)
E24_PIPE = (1280, 5120, 256, 4)
E24_TOL = 1e-4  # × max(1, max|one-process|): fp32 sums in other orders
E24_REPS = 3  # timed forward + backward runs a side, after one warm-up

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
# phase 6c: PLMS against DDIM from the same latents (SD_ROWS prompts x 1
# image at SD_STEPS), a short PLMS chain through the kernels against their
# plain versions (TF32 off), sd_eval (imageclassify, compute_fid,
# nudenet), the diffusers export; then masked Adam, spack and
# device_prefetch on phase 4's ResNet-18, mask and CIFAR-shaped arrays
PLMS_CHECK_STEPS = 4
# × max(1, max|plain|): the latents after PLMS_CHECK_STEPS; three whole
# runs on an H100 read 4.338e-7 each (of max|plain| 19.784), and a K2
# without its 3xTF32 split (~1e-3 relative a product) would exceed it
PLMS_TOL = 1e-5
FID_IMAGES = 32  # synthetic PNGs in each compute_fid folder
CLASSIFY_IMAGES = 128  # PNGs imageclassify's rate is timed over
ADAM_STEPS, ADAM_LR = 20, 1e-4
SPACK_BATCHES = 64  # random gathers of BATCH records timed per reader
PREFETCH_STEPS = 24  # ResNet-18 SGD steps timed per transfer
# ImageNet: a seeded save_to_disk folder, decoded at 224 (the reference's
# eval size), cut in count from ImageNet-1k's 1.28M/50,000 images
IMAGENET_TRAIN, IMAGENET_VAL, IMAGENET_CLASSES = 512, 128, 8
IMAGENET_BS, IMAGENET_FORGET = 64, 32

# phase 5c: FID/Inception and the DDPM classifier on phase 5b's samples
INCEPTION_CHECK, INCEPTION_TOL = 8, 1e-4  # images; × max(1, max|CPU|)
FID_REF, FID_TIMED = 64, 2_560  # reference PNGs; images timed (> 2,048)
FID_SELF_TOL = 1e-6  # a set's FID against itself, × max(1, tr Σ)
CLS_LIMIT, CLS_BS = 256, 64  # ddpm_classifier train: 4 steps at 224 px


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
    for shape in ATTN_PATH + ATTN_RAGGED + ATTN_FIM + ATTN_DP:
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
    """K2 at the U-Net's self- and cross-attention shapes, at ESD's, at
    phase 8's sharded ones and at D = 512 (the VAE), K3a/K3b at the
    U-Net's, ESD's trained forward and phase 8's:
    errors against the plain versions,
    times against the bound, the plain version and SDPA. Returns the
    per-shape rows."""
    import torch
    import torch.nn.functional as F

    from salun_torch.kernels import flash_attention as fa

    rows = []
    gen = torch.Generator(device=device).manual_seed(4)
    for shape in ATTN_SD_UNET + ATTN_SD_ESD + ATTN_SD_SHARDED + ATTN_SD_VAE:
        b, nq, nk, d = shape
        backward = (shape in ATTN_SD_UNET or shape in ATTN_SD_ESD_BWD
                    or shape in ATTN_SD_SHARDED)
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
    gc.collect()
    torch.cuda.empty_cache()
    dp, sharded = dp_sd(device, work, ckpt, mask_file, cfg, csv)
    dp.update(sharded_state_paths(device, ckpt, mask_file, cfg, *sharded))
    rest = sd_rest_paths(device, work, ckpt, mask_file, cfg,
                         result["losses"])
    rest.update(sd_sample_eval_paths(device, work, ckpt, cfg, rows))
    shutil.rmtree(work, ignore_errors=True)
    return {"sd": total, **rest, **dp}


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


# ----------------------------------------------------------------- phase 6c


def _plain_sd_kernels():
    """Swap K2's and K4's wrappers for their plain versions where the SD
    models call them (``kernels.attention`` imports K2's by name); returns
    a function that puts the wrappers back."""
    from salun_torch.kernels import attention
    from salun_torch.kernels import flash_attention as fa
    from salun_torch.kernels import groupnorm_silu as gn

    def plain_fwd(q, k, v, scale, need_lse=False):
        o, lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        return o, (lse if need_lse else None)

    saved = [(fa, "flash_attention_fwd", fa.flash_attention_fwd),
             (attention, "flash_attention_fwd", attention.flash_attention_fwd),
             (gn, "groupnorm_silu", gn.groupnorm_silu)]
    fa.flash_attention_fwd = attention.flash_attention_fwd = plain_fwd
    gn.groupnorm_silu = gn.groupnorm_silu_reference

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return restore


def plms_vs_ddim(device, ckpt: Path, cfg, rows) -> tuple:
    """PLMS and DDIM at SD_STEPS from the same latents through
    ``SDModules.sample``, each call's launches counted (PLMS must launch
    exactly two U-Net forwards' worth of K2 and K4 more than DDIM); then
    PLMS_CHECK_STEPS of PLMS through the kernels against the same chain
    with their plain versions. Returns (PLMS launches, images in [0, 1]
    as uint8 NHWC of both samplers)."""
    import torch

    from salun_torch.ckpt import load_compvis_state_dict, load_sd_modules
    from salun_torch.diffusion.sampling import ldm_uniform_timesteps
    from salun_torch.sd.config import modules_from_config
    from salun_torch.sd.unet import kernel_sites
    from salun_torch.utils.device import set_tf32

    sd = modules_from_config(cfg, device, seed=0)
    load_sd_modules(sd, load_compvis_state_dict(str(ckpt)))
    prompts = [str(r["prompt"]) for r in rows]
    n, side = len(prompts), SD_IMAGE // 8
    z = sd.initial_latents(n, side, torch.Generator(device).manual_seed(13))
    kernels = _sd_kernels()
    names = list(kernels)
    unet = kernel_sites(cfg.unet)
    dec = 2 * len(cfg.vae.ch_mult) * (cfg.vae.num_res_blocks + 1) + 5
    grid = len(ldm_uniform_timesteps(cfg.timesteps, SD_STEPS))
    n_fwd = {"plms": grid + 1, "ddim": grid - 1}
    got, seconds, images = {}, {}, {}
    for sampler in ("plms", "ddim"):
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sd.sample(prompts, guidance=SD_GUIDANCE, steps=SD_STEPS,
                        image_size=side, sampler=sampler,
                        initial_latents=z)
        torch.cuda.synchronize()
        seconds[sampler] = time.perf_counter() - t0
        got[sampler] = {k: f.launches for k, f in kernels.items()}
        want = dict(zip(names, (0, n_fwd[sampler] * unet["k2"] + 1, 0, 0,
                                n_fwd[sampler] * unet["k4"] + dec, 0)))
        if got[sampler] != want:
            fail(f"SD {sampler}: launches {got[sampler]}, the path implies "
                 f"{want}")
        if not (tuple(img.shape) == (n, 3, SD_IMAGE, SD_IMAGE)
                and bool(torch.isfinite(img).all())
                and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0):
            fail(f"SD {sampler} images {tuple(img.shape)} in "
                 f"[{float(img.min())}, {float(img.max())}]")
        images[sampler] = (img.permute(0, 2, 3, 1).cpu().numpy() * 255
                           ).astype("uint8")
    extra = {k: got["plms"][k] - got["ddim"][k] for k in names}
    if extra != dict(zip(names, (0, 2 * unet["k2"], 0, 0, 2 * unet["k4"],
                                 0))):
        fail(f"PLMS launched {extra} more than DDIM, not two U-Net "
             f"forwards' worth")
    log(f"SD PLMS vs DDIM ({n} prompts x 1 image, {SD_STEPS} steps, "
        f"guidance {SD_GUIDANCE}, {SD_IMAGE}x{SD_IMAGE}, the same latents): "
        f"U-Net forwards {n_fwd['plms']} against {n_fwd['ddim']}; launches "
        f"PLMS {got['plms']}, DDIM {got['ddim']}, PLMS - DDIM = two "
        f"forwards ({extra}); images finite in [0, 1]; seconds PLMS "
        f"{seconds['plms']:.3f}, DDIM {seconds['ddim']:.3f} (ratio "
        f"{seconds['plms'] / seconds['ddim']:.4f}, forwards ratio "
        f"{n_fwd['plms'] / n_fwd['ddim']:.4f})")

    # the short chain: kernels against their plain versions, TF32 off and
    # cuDNN deterministic, so the two kernels are all that differs
    set_tf32(False)
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        def chain():
            return sd.sample(prompts, guidance=SD_GUIDANCE,
                             steps=PLMS_CHECK_STEPS, image_size=side,
                             sampler="plms", initial_latents=z,
                             return_latents=True)

        for f in kernels.values():
            f.launches = 0
        fast = chain()
        torch.cuda.synchronize()
        check = {k: f.launches for k, f in kernels.items()}
        for f in kernels.values():
            f.launches = 0
        restore = _plain_sd_kernels()
        try:
            plain = chain()
            torch.cuda.synchronize()
        finally:
            restore()
        leaked = {k: f.launches for k, f in kernels.items() if f.launches}
        if leaked:
            fail(f"the plain PLMS chain still launched kernels: {leaked}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was
        set_tf32(True)
    fwd = len(ldm_uniform_timesteps(cfg.timesteps, PLMS_CHECK_STEPS)) + 1
    if check != dict(zip(names, (0, fwd * unet["k2"], 0, 0,
                                 fwd * unet["k4"], 0))):
        fail(f"the {PLMS_CHECK_STEPS}-step PLMS chain launched {check}")
    scale = max(1.0, float(plain.abs().max()))
    err = float((fast - plain).abs().max()) / scale
    if not (bool(torch.isfinite(fast).all()) and err <= PLMS_TOL):
        fail(f"PLMS through K2/K4 differs from the plain chain by {err:.3e} "
             f"of max(1, max|plain|) = {scale:.3f} (tolerance {PLMS_TOL})")
    log(f"PLMS {PLMS_CHECK_STEPS} steps ({fwd} U-Net forwards, launches "
        f"{check}) through K2/K4 against their plain versions: latents "
        f"within {err:.3e} of max(1, max|plain|) = {scale:.3f} (tolerance "
        f"{PLMS_TOL}, TF32 off)")
    del sd
    return got["plms"], images


def write_classifier_weights(path: Path) -> None:
    """A seeded torchvision-format ResNet-50 state dict (ImageNet stem,
    1,000 classes) with BatchNorm statistics moved off their init; the fc
    is scaled by 1/60, since the seeded features give logits spread ~120
    over the classes and the softmax would underflow to ties at 0."""
    import torch

    from salun_torch.models import create_model

    model = create_model("resnet50", 1000, imagenet=True, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))
        model.fc.weight.div_(60.0)
    torch.save(model.state_dict(), path)


def sd_eval_checks(device, work: Path, rows, images) -> None:
    """``salun_torch.cli.sd_eval``: imageclassify over the PLMS and DDIM
    PNGs with the prompts CSV on the card and on the CPU (top-1 equal),
    compute_fid between two synthetic folders and of one against itself,
    nudenet without the package."""
    import csv as csv_mod

    import numpy as np

    from salun_torch.cli import sd_eval
    from salun_torch.cli.ddpm_evaluator import read_images_folder
    from salun_torch.cli.ddpm_sample import write_png
    from salun_torch.evalx.inception import build_inception, make_feature_fn

    folder = work / "plms_ddim"
    folder.mkdir()
    for j, r in enumerate(rows):
        for i, sampler in enumerate(("plms", "ddim")):
            write_png(str(folder / f"{r['case_number']}_{i}.png"),
                      images[sampler][j])
    prompts = work / "prompts.csv"
    weights = work / "resnet50.pth"
    write_classifier_weights(weights)
    out = []  # the card twice (cold, then warm), then the CPU
    for i, dev in enumerate((device, device, "cpu")):
        path = work / f"classify_{i}.csv"
        stats = sd_eval.main(["imageclassify", "--folder_path", str(folder),
                              "--prompts_path", str(prompts), "--save_path",
                              str(path), "--classifier_weights", str(weights),
                              "--batch_size", "4", "--device", str(dev)])
        with open(path, newline="") as f:
            out.append((list(csv_mod.reader(f)), stats))
    (card, cold), (warm_rows, warm), (cpu, _) = out
    header = ["", "case_number", "prompt", "evaluation_seed"] + [
        f"{w}_top{k}" for k in range(1, 6)
        for w in ("category", "index", "scores")]
    n_img = 2 * len(rows)
    if card[0] != header or cpu[0] != header or len(card) != n_img + 1:
        fail(f"imageclassify CSV header {card[0]}, {len(card) - 1} rows")
    col = header.index("index_top1")
    top1 = [r[col] for r in card[1:]]
    if top1 != [r[col] for r in cpu[1:]] or top1 != [
            r[col] for r in warm_rows[1:]]:
        fail(f"imageclassify top-1 on the card {top1} differs from the "
             f"CPU's {[r[col] for r in cpu[1:]]}")
    log(f"sd_eval imageclassify ({n_img} PNGs, ResNet-50 at 224, seeded "
        f".pth, prompts CSV): {len(card) - 1} rows, columns as the JAX "
        f"CLI's, top-1 {top1} equal to the CPU run's and to a second card "
        f"call's; the network's seconds for one batch of 4 on the card "
        f"(TF32 off): {cold['seconds']:.4f} in a first call (cuDNN's "
        f"algorithm choice included), {warm['seconds']:.4f} in a second")

    # the rate: a folder of CLASSIFY_IMAGES at the CLI's default batch
    # size, the images the four above shifted and mirrored by a seed
    many = work / "classify_rate"
    many.mkdir()
    rng = np.random.default_rng(31)
    bases = [images[k][j] for j in range(len(rows)) for k in images]
    for i in range(CLASSIFY_IMAGES):
        shift = tuple(rng.integers(0, SD_IMAGE, 2))
        img = np.roll(bases[i % len(bases)], shift, axis=(0, 1))
        write_png(str(many / f"{i}_0.png"),
                  img[:, ::-1] if rng.random() < 0.5 else img)
    t0 = time.perf_counter()
    rate = sd_eval.main(["imageclassify", "--folder_path", str(many),
                         "--save_path", str(work / "classify_rate.csv"),
                         "--classifier_weights", str(weights), "--device",
                         str(device)])
    wall = time.perf_counter() - t0
    with open(work / "classify_rate.csv", newline="") as f:
        table = list(csv_mod.reader(f))
    col = table[0].index("index_top1") if table else -1
    if (rate["images"] != CLASSIFY_IMAGES or len(table) != CLASSIFY_IMAGES + 1
            or col < 0 or not all(0 <= int(r[col]) < 1000
                                  for r in table[1:])):
        fail(f"imageclassify over {CLASSIFY_IMAGES} PNGs: {rate['images']} "
             f"images, {len(table) - 1} rows")
    log(f"sd_eval imageclassify rate ({CLASSIFY_IMAGES} PNGs of "
        f"{SD_IMAGE}x{SD_IMAGE}, the default batch 16, per-image CSV, one "
        f"call): {CLASSIFY_IMAGES / wall:.1f} images/s for the whole call "
        f"({wall:.3f} s: decode, network, CSV), the network "
        f"{rate['images'] / rate['seconds']:.1f} images/s "
        f"({rate['seconds']:.4f} s, its first batch of 16 included)")

    for name, seed in (("fid_a", 21), ("fid_b", 22)):
        write_png_folder(work / name, FID_IMAGES, seed)
    a, b = str(work / "fid_a"), str(work / "fid_b")
    fid_ab = sd_eval.main(["compute_fid", a, b, "--device", str(device)])
    fid_aa = sd_eval.main(["compute_fid", a, a, "--device", str(device)])
    pool = make_feature_fn(build_inception(None, device), 32)(
        read_images_folder(a))[0]
    trace = float(np.trace(np.cov(pool, rowvar=False)))
    if not (math.isfinite(fid_ab) and fid_ab > 0
            and abs(fid_aa) <= FID_SELF_TOL * max(1.0, trace)):
        fail(f"compute_fid: {fid_ab} between two folders, {fid_aa} of one "
             f"against itself (tr Σ {trace})")
    log(f"sd_eval compute_fid ({FID_IMAGES} + {FID_IMAGES} synthetic PNGs, "
        f"seeded Inception): {fid_ab:.4f}; a folder against itself "
        f"{fid_aa:.3e} (≤ {FID_SELF_TOL} x max(1, tr Σ = {trace:.4e}))")

    try:
        sd_eval.main(["nudenet", "--folder", str(folder), "--prompts_path",
                      str(prompts), "--save_path", str(work / "nude.csv")])
    except SystemExit as e:
        if "nudenet is not installed" not in str(e):
            fail(f"sd_eval nudenet stopped with {e}")
        log("sd_eval nudenet: the package is absent, the CLI stops with its "
            "instructions")
    else:
        fail("sd_eval nudenet ran without the nudenet package's guard")


def diffusers_export_check(trained: Path, cfg) -> None:
    """The trained U-Net of ``trained`` (a CompVis .ckpt) through
    ``save_diffusers_unet`` and back through ``import_diffusers_unet``, in
    the layout of ``cfg``'s U-Net: every key mapped once, the round trip
    bitwise."""
    import torch

    from salun_torch.ckpt import load_compvis_state_dict
    from salun_torch.sd.diffusers_export import (import_diffusers_unet,
                                                 save_diffusers_unet)

    prefix = "model.diffusion_model."
    unet = {k[len(prefix):]: v for k, v in
            load_compvis_state_dict(str(trained)).items()
            if k.startswith(prefix)}
    u = cfg.unet
    layout = {"num_levels": len(u.channel_mult),
              "num_res_blocks": u.num_res_blocks,
              "attn_levels": tuple(lv for lv in range(len(u.channel_mult))
                                   if 2 ** lv in u.attention_resolutions)}
    path = trained.parent / "diffusers_unet.bin"
    t0 = time.perf_counter()
    save_diffusers_unet(unet, str(path), **layout)
    back = import_diffusers_unet(
        torch.load(path, map_location="cpu", weights_only=True), unet,
        **layout)
    seconds = time.perf_counter() - t0
    n = sum(v.numel() for v in unet.values())
    if list(back) != list(unet) or not all(torch.equal(back[k], v)
                                           for k, v in unet.items()):
        fail("the diffusers export of the trained U-Net does not import "
             "back bitwise")
    log(f"diffusers export of random_label's U-Net ({layout}): "
        f"{len(unet)} keys ({n} parameters) written and imported back "
        f"bitwise in "
        f"{seconds:.3f} s")
    path.unlink()


def sd_sample_eval_paths(device, work: Path, ckpt: Path, cfg, rows) -> dict:
    """Phase 6c's SD part; returns the PLMS call's launches."""
    import gc

    import torch

    t0 = time.perf_counter()
    launches, images = plms_vs_ddim(device, ckpt, cfg, rows)
    gc.collect()
    torch.cuda.empty_cache()
    sd_eval_checks(device, work, rows, images)
    diffusers_export_check(work / "rl" / "compvis.ckpt", cfg)
    log(f"phase 6c (SD): {time.perf_counter() - t0:.3f} s")
    return {"sd_plms": launches}


def masked_adam_path(device) -> None:
    """ADAM_STEPS of masked Adam (``build_optimizer(kind="adam")``) on
    phase 4's seeded ResNet-18 with its 0.5 mask over RL's forget loss
    (random labels on the forget batches): masked-out weights stay θ₀ and
    both moments 0 there, bitwise."""
    import torch

    from salun_torch.ckpt import load_mask
    from salun_torch.cli.setup import load_model
    from salun_torch.core.masked_opt import FlatParams, build_optimizer
    from salun_torch.core.methods.common import mask_tensors
    from salun_torch.core.train import generator_source, train_step
    from salun_torch.data.loader import to_device
    from salun_torch.models import create_model
    from salun_torch.utils.device import make_generator

    model = create_model("resnet18", 10, seed=0, device=device)
    load_model(model, str(WORK / "resnet18_seed0.pt"))
    mask = load_mask(str(WORK / "out" / "with_0.5.pt"), device)
    flat = FlatParams(model.parameters())
    theta0 = flat.flat.clone()
    keep = flat.flatten(mask_tensors(model, mask))
    opt = build_optimizer(flat, ADAM_LR, mask=keep, theta0=theta0,
                          kind="adam")
    loaders, _, _ = unlearn_loaders([
        "--dataset", "cifar10", "--data", str(WORK / "data"), "--arch",
        "resnet18", "--batch_size", str(BATCH), "--num_indexes_to_replace",
        str(N_FORGET), "--class_to_replace", "-1", "--device", "cpu"])
    source = generator_source(make_generator(0, device), 10)
    losses, t_first = [], 0.0
    t0 = time.perf_counter()
    while len(losses) < ADAM_STEPS:
        for b in loaders["forget"]:
            batch = to_device(b, device)
            rand = source(batch["image"].shape[0], random_labels=True)
            m = train_step(model, opt, batch, rand, random_labels=True)
            losses.append(float(m["loss"]))  # synchronises
            if len(losses) == 1:
                t_first = time.perf_counter()
            if len(losses) == ADAM_STEPS:
                break
    ms = 1e3 * (time.perf_counter() - t_first) / (ADAM_STEPS - 1)
    out = keep == 0
    p = flat.flat
    if not torch.equal(p[out], theta0[out]):
        fail("masked Adam moved a masked-out weight off θ₀")
    if bool(opt.mu[out].any()) or bool(opt.nu[out].any()):
        fail("masked Adam left a moment non-zero on a masked-out weight")
    moved = int((p[~out] != theta0[~out]).sum())
    if moved == 0 or not all(map(math.isfinite, losses)):
        fail(f"masked Adam: {moved} kept weights moved, losses {losses}")
    log(f"masked Adam ({ADAM_STEPS} steps, lr {ADAM_LR}, bs {BATCH}, "
        f"ResNet-18 {p.numel()} parameters, phase 4's 0.5 mask, RL's forget "
        f"loss): masked-out weights θ₀ bitwise, both moments 0 there; "
        f"{moved} kept weights moved; losses finite "
        f"{[round(x, 4) for x in losses[:3]]}..{round(losses[-1], 4)}; "
        f"{ms:.3f} ms/step over steps 2-{ADAM_STEPS}")


def spack_path() -> None:
    """Phase 4's synthetic CIFAR arrays packed with ``pack_arrays``; random
    gathers of BATCH records by the native reader against the arrays
    (bitwise), and its GB/s against the numpy reader's."""
    import numpy as np

    from salun_torch.data.datasets import synthetic
    from salun_torch.data.pack import SpackReader, pack_arrays

    ds = synthetic(n=N_TRAIN, seed=0)
    path = WORK / "cifar.spack"
    t0 = time.perf_counter()
    pack_arrays(str(path), ds.data, ds.targets)
    t_pack = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, N_TRAIN, BATCH) for _ in range(SPACK_BATCHES)]
    rate = {}
    for native in (True, False):
        r = SpackReader(str(path), native=native)
        if native:
            for idx in batches:
                flat, labels = r.gather(idx)
                if not (np.array_equal(flat.reshape(ds.data[idx].shape),
                                       ds.data[idx])
                        and np.array_equal(labels, ds.targets[idx])):
                    fail("spack's native gather differs from the arrays")
        t0 = time.perf_counter()
        for idx in batches:
            r.gather(idx)
        rate[native] = (SPACK_BATCHES * BATCH * ds.data[0].nbytes
                        / (time.perf_counter() - t0) / 1e9)
        r.close()
    log(f"spack: {N_TRAIN} records of {ds.data[0].nbytes} B packed in "
        f"{t_pack:.3f} s; {SPACK_BATCHES} random gathers of {BATCH} bitwise "
        f"equal to the arrays; native {rate[True]:.3f} GB/s against the "
        f"numpy reader's {rate[False]:.3f} GB/s (host, 4 threads)")
    path.unlink()


def device_prefetch_path(device) -> None:
    """``device_prefetch`` batches against a direct ``.to(device)``
    (bitwise), then PREFETCH_STEPS ResNet-18 SGD steps fed each way."""
    import numpy as np
    import torch

    from salun_torch.core.masked_opt import SGD, FlatParams
    from salun_torch.core.train import generator_source, train_step
    from salun_torch.data.datasets import synthetic
    from salun_torch.data.pipeline import device_prefetch
    from salun_torch.models import create_model
    from salun_torch.utils.device import make_generator

    ds = synthetic(n=PREFETCH_STEPS * BATCH, seed=0)
    host = [{"image": ds.data[i:i + BATCH], "label": ds.targets[i:i + BATCH],
             "weight": np.ones(BATCH, np.float32)}
            for i in range(0, len(ds), BATCH)]

    def direct(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    for got, b in zip(device_prefetch(iter(host), device), host):
        want = direct(b)
        if not all(got[k].device == want[k].device
                   and torch.equal(got[k], want[k]) for k in b):
            fail("device_prefetch gave a batch unlike a direct .to(device)")
    model = create_model("resnet18", 10, seed=0, device=device)
    opt = SGD(FlatParams(model.parameters()), 0.01)
    source = generator_source(make_generator(0, device), 10)

    def run(feed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in feed:
            batch = {"image": b["image"].permute(0, 3, 1, 2).contiguous(),
                     "label": b["label"], "weight": b["weight"]}
            train_step(model, opt, batch, source(BATCH))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(host)

    run(map(direct, host))  # warm-up
    ms = {}
    for order in ("direct", "prefetch", "prefetch", "direct"):
        feed = (map(direct, host) if order == "direct"
                else device_prefetch(iter(host), device))
        ms.setdefault(order, []).append(run(feed))
    log(f"device_prefetch: {len(host)} batches bitwise equal to a direct "
        f".to(device); ResNet-18 SGD step (bs {BATCH}) fed directly "
        f"{ms['direct']} ms, through device_prefetch {ms['prefetch']} ms "
        f"(runs in turns; the overlap it buys: "
        f"{min(ms['direct']) - min(ms['prefetch']):.3f} ms/step)")


def write_imagenet_folder(root: Path) -> None:
    """A seeded ImageNet-format ``DatasetDict`` (``image``, ``label`` of
    1,000 classes; train and validation) written with ``save_to_disk``:
    non-square RGB images and every fifth one grayscale, in IMAGENET_CLASSES
    classes."""
    import datasets
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(31)
    classes = rng.choice(1000, IMAGENET_CLASSES, replace=False)

    def split(n):
        imgs, labels = [], []
        for i in range(n):
            h, w = (int(x) for x in rng.integers(160, 360, 2))
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
            imgs.append(img.convert("L") if i % 5 == 0 else img)
            labels.append(int(classes[i % IMAGENET_CLASSES]))
        return datasets.Dataset.from_dict(
            {"image": imgs, "label": labels},
            features=datasets.Features({
                "image": datasets.Image(),
                "label": datasets.ClassLabel(num_classes=1000)}))

    datasets.DatasetDict({"train": split(IMAGENET_TRAIN),
                          "validation": split(IMAGENET_VAL)}
                         ).save_to_disk(str(root))


def imagenet_path(device) -> dict:
    """ImageNet from a local ``save_to_disk`` folder: ``imagenet()``
    decodes both splits at 224; ``ImageNetLoader``'s validation batches
    through ``device_prefetch`` equal those arrays bitwise on the card;
    then ``main_forget --dataset imagenet --imagenet_arch`` (FT, 1 epoch)
    with finite metrics and no K1 launch. Returns its K1 launches."""
    import numpy as np
    import torch

    from salun_torch.cli import main_forget
    from salun_torch.data.datasets import imagenet
    from salun_torch.data.imagenet import ImageNetLoader
    from salun_torch.data.pipeline import device_prefetch
    from salun_torch.kernels.masked_update import masked_sgd_update

    root = WORK / "imagenet-1k"
    write_imagenet_folder(root)
    t0 = time.perf_counter()
    val = imagenet(str(root), train=False)
    t_decode = time.perf_counter() - t0
    loader = ImageNetLoader(str(root), batch_size=IMAGENET_BS, image_size=224)
    n = 0
    for b in device_prefetch(loader.loaders(-1)["val"](), device):
        k = int(b["weight"].sum())
        want = torch.from_numpy(val.data[n:n + k]).to(device)
        if not (torch.equal(b["image"][:k], want)
                and np.array_equal(b["label"][:k].cpu().numpy(),
                                   val.targets[n:n + k])):
            fail("ImageNetLoader's batches differ from imagenet()'s arrays")
        n += k
    loader.close()
    if n != IMAGENET_VAL:
        fail(f"ImageNetLoader gave {n} validation images of {IMAGENET_VAL}")
    masked_sgd_update.launches = 0
    out = WORK / "imagenet_out"
    results = main_forget.main([
        "--dataset", "imagenet", "--data", str(root), "--arch", "resnet18",
        "--imagenet_arch", "--batch_size", str(IMAGENET_BS), "--unlearn",
        "FT", "--unlearn_epochs", "1", "--unlearn_lr", "0.01",
        "--class_to_replace", str(int(val.targets[0])),
        "--num_indexes_to_replace", str(IMAGENET_FORGET), "--save_dir",
        str(out), "--device", str(device)])
    torch.cuda.synchronize()
    launches = masked_sgd_update.launches
    check_metrics(results, "main_forget --dataset imagenet")
    if launches:
        fail(f"main_forget on ImageNet launched K1 {launches} times")
    log(f"ImageNet ({IMAGENET_TRAIN} + {IMAGENET_VAL} seeded images of "
        f"{IMAGENET_CLASSES} classes, save_to_disk): imagenet() decoded the "
        f"validation split at 224 in {t_decode:.3f} s "
        f"({IMAGENET_VAL / t_decode:.1f} images/s on the host, indicative "
        f"only: {IMAGENET_VAL} noise images); ImageNetLoader's "
        f"batches through device_prefetch equal it bitwise; main_forget "
        f"--dataset imagenet --imagenet_arch (ResNet-18, FT 1 epoch, bs "
        f"{IMAGENET_BS}, {IMAGENET_FORGET} forget): UA {results['UA']:.2f} "
        f"RA {results['retain']:.2f} TA {results['test']:.2f}, unlearning "
        f"{results['seconds']['unlearn']:.3f} s, K1 0 launches")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"K1 masked_sgd_update": launches}


def scale_paths(device) -> dict:
    """Phase 6c's rest: masked Adam, spack, device_prefetch and ImageNet,
    with TF32 on as on the classification main path (``sd_eval`` turns it
    off); returns the ImageNet call's K1 launches."""
    from salun_torch.utils.device import set_tf32

    set_tf32(True)
    t0 = time.perf_counter()
    masked_adam_path(device)
    spack_path()
    device_prefetch_path(device)
    launches = imagenet_path(device)
    log(f"phase 6c (masked Adam, spack, device_prefetch, ImageNet): "
        f"{time.perf_counter() - t0:.3f} s")
    return {"main_forget --dataset imagenet": launches}


# ----------------------------------------------------------------- phase 7


def _jsonable(x):
    """``x`` with what JSON cannot hold (tensors, masks) left out."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()
                if _jsonable(v) is not None}
    if isinstance(x, (list, tuple)):
        items = [_jsonable(v) for v in x]
        return None if any(v is None for v in items) else items
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    return None


def dp_child(args: list) -> None:
    """One rank of a phase-7/8 launch, ``torchrun --nproc_per_node 2
    chip_smoke.py --dp-child <out> <calls.json>``: the group comes up once
    (a CLI's ``main`` keeps a group it did not bring up), then each call
    in turn, ``{"module": <CLI module, or "tp" for tp_work>, "argv": [...],
    "hooks": {...}}``: every kernel's count is set to 0 just before it and
    read just after, with its time, peak memory, backend and the time its
    gradient all-reduces took, into ``<out>.<i>.rank<r>.json``;
    ``hooks`` are :func:`_sharded_hooks`' settings for that call."""
    import gc
    import importlib
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from salun_torch.dist import context as dist_ctx
    from salun_torch.dist import multihost

    out, calls = args[0], json.loads(Path(args[1]).read_text())
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    reduce = {}
    inner = dist_ctx.all_reduce_

    def timed_all_reduce(tensors, *a, **kw):
        tensors = list(tensors)
        sync()
        t0 = time.perf_counter()
        inner(tensors, *a, **kw)
        sync()
        reduce["ms"] += 1e3 * (time.perf_counter() - t0)
        reduce["calls"] += 1
        reduce["bytes"] += sum(t.numel() * t.element_size() for t in tensors)

    dist_ctx.all_reduce_ = timed_all_reduce
    device = "cuda" if cuda else "cpu"
    backend = multihost.initialize(device)
    rank = int(os.environ["RANK"])
    kernels = _sd_kernels()
    for i, call in enumerate(calls):
        hooks = call.get("hooks") or {}
        rec = {"probe": collectives_probe(device)} if hooks.get("probe") \
            else {}
        uninstall = _sharded_hooks(rec, sync, hooks)
        reduce.update(calls=0, ms=0.0, bytes=0)
        for f in kernels.values():
            f.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if call["module"] == "tp":
            result = tp_work(call["argv"][0], rec)
        elif call["module"] == "e24":
            result = e24_work(rec)
        else:
            result = importlib.import_module(call["module"]).main(
                call["argv"])
        sync()
        rec.update({"rank": rank, "seconds": time.perf_counter() - t0,
                    "launches": {k: f.launches for k, f in kernels.items()},
                    "peak_bytes": (torch.cuda.max_memory_allocated() if cuda
                                   else 0),
                    "backend": backend, "all_reduce": dict(reduce),
                    "result": _jsonable(result)})
        Path(f"{out}.{i}.rank{rank}.json").write_text(json.dumps(rec))
        uninstall()
        del result
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    multihost.shutdown()


def collectives_probe(device) -> dict:
    """Phase 8a, in a rank just after its group came up: what gloo carries
    for tensors on ``device``: ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` against their exact values, and the (2, 1)
    and (1, 2) ``DeviceMesh`` with their sub-groups' backends."""
    import torch
    import torch.distributed as dist

    from salun_torch.dist.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    r, n = dist.get_rank(), dist.get_world_size()
    out = {"device": str(dev)}
    x = torch.full((3, 5), float(r + 1), device=dev)
    gathered = torch.empty(3 * n, 5, device=dev)
    dist.all_gather_into_tensor(gathered, x)
    want = torch.cat([torch.full((3, 5), float(i + 1)) for i in range(n)])
    out["all_gather_into_tensor"] = bool(torch.equal(gathered.cpu(), want))
    y = torch.arange(4.0 * n, device=dev) * (r + 1)
    part = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(part, y)
    want = (torch.arange(4.0 * n) * sum(range(1, n + 1)))[4 * r:4 * r + 4]
    out["reduce_scatter_tensor"] = bool(torch.equal(part.cpu(), want))
    for data, model in ((n, 1), (1, n)):
        m = make_mesh(data=data, model=model, device=dev)
        out[f"mesh_{data}x{model}"] = {
            "sizes": [m.data_mesh.size(), m.model_mesh.size()],
            "backends": [dist.get_backend(m.data_mesh.get_group()),
                         dist.get_backend(m.model_mesh.get_group())]}
    return out


def _sharded_hooks(rec: dict, sync, cfg: dict):
    """Phase 8's instruments around one call of a ``--dp-child`` rank, as
    ``cfg`` asks (nothing when empty):

    - ``grads_out``: rank 0 saves the U-Net's gradients of the first step
      (summed over the ranks, before the grad mask and Adam) whole there;
    - ``grads_ref``: this rank's shard of the first step's gradients
      against that file's; ``ckpt``: the sharded U-Net and Adam state saved
      there asynchronously after the first step's Adam (each rank's shard
      digests recorded), waited for at the second step, before its Adam;
      with either, the all-gathers and reduce-scatters are timed
      (synchronised, so they run one at a time), and the hooks' times
      between the steps.

    The hooks wrap ``SDOptimizer.step`` (once a step, after the backward
    and the gradients' sum). Returns a function that takes them off."""
    grads_out = cfg.get("grads_out")
    if not grads_out and not cfg.get("grads_ref"):
        return lambda: None
    import torch
    import torch.distributed as dist

    from salun_torch.dist import context as dist_ctx
    from salun_torch.dist import fsdp
    from salun_torch.sd import trainers

    coll = {"all_gather": [0, 0.0, 0], "reduce_scatter": [0, 0.0, 0]}
    busy = [False]

    def timed(kind, fn):
        def call(*args, **kw):
            if busy[0]:
                return fn(*args, **kw)
            busy[0] = True
            try:
                sync()
                t0 = time.perf_counter()
                work = fn(*args, **kw)
                if work is not None:
                    work.wait()
                sync()
            finally:
                busy[0] = False
            out_t = args[0] if args else kw.get("output_tensor",
                                                  kw.get("output"))
            c = coll[kind]
            c[0] += 1
            c[1] += 1e3 * (time.perf_counter() - t0)
            if out_t is not None:
                c[2] += out_t.numel() * out_t.element_size()
            return work
        return call

    saved = []
    if cfg.get("grads_ref"):
        for kind, names in (("all_gather", ("all_gather_into_tensor",
                                            "all_gather_single",
                                            "_all_gather_base")),
                            ("reduce_scatter", ("reduce_scatter_tensor",
                                                "reduce_scatter_single",
                                                "_reduce_scatter_base"))):
            for name in names:
                if hasattr(dist, name):
                    saved.append((name, getattr(dist, name)))
                    setattr(dist, name, timed(kind, getattr(dist, name)))
    inner = trainers.SDOptimizer.step
    rec["steps"] = []
    held = {}

    def grads_against_ref(opt) -> dict:
        ref = torch.load(cfg["grads_ref"], map_location="cpu", mmap=True,
                         weights_only=True)
        mesh = dist_ctx.active_mesh()
        scales, diffs = {}, {}
        for name, p in zip(opt.names, opt.params):
            want = ref[name].to(p.grad.device if not fsdp.is_sharded(p)
                                else fsdp.local(p.grad).device)
            scales[name] = float(want.abs().max())
            if fsdp.is_sharded(p):
                (pl,) = p.grad.placements
                want = want.chunk(mesh.data, pl.dim)[mesh.data_index]
            diffs[name] = float((fsdp.local(p.grad) - want).abs().max())
        top = max(scales.values())
        errs = {n: diffs[n] / (scales[n] if scales[n] > SHARDED_NOISE * top
                               else top) for n in diffs}
        worst = max(errs, key=errs.get)
        return {"worst": errs[worst], "name": worst, "top": top,
                "noise_tensors": sum(scales[n] <= SHARDED_NOISE * top
                                     for n in scales)}

    def shard_digests(opt) -> dict:
        """Digests of this rank's pieces of the trained state: its shard
        of each sharded tensor, the whole ones on data index 0 only."""
        mesh = dist_ctx.active_mesh()
        st = opt.state()
        names = opt.names
        groups = {"unet": [st["unet"][n] for n in names]}
        for key in ("exp_avg", "exp_avg_sq", "step"):
            groups[key] = [st["adam"][n][key] for n in names]
        out = {}
        for key, ts in groups.items():
            pieces = fsdp.local_pieces([t.detach() for t in ts], mesh)
            out[key] = dist_ctx.digest(pieces)
        out["bytes"] = sum(fsdp.local(t).numel() * 4
                           for ts in groups.values() for t in ts)
        return out

    def step(self):
        sync()
        t_in = time.perf_counter()
        n = len(rec["steps"]) + 1
        entry = {"t_in": t_in, "collectives": {k: list(v) for k, v in
                                               coll.items()},
                 "peak_bytes": torch.cuda.max_memory_allocated()
                 if torch.cuda.is_available() else 0}
        rec["steps"].append(entry)
        if n == 1 and grads_out and dist.get_rank() == 0:
            torch.save({name: p.grad.detach().cpu()
                        for name, p in zip(self.names, self.params)},
                       grads_out)
        if n == 1 and cfg.get("grads_ref"):
            rec["grads"] = grads_against_ref(self)
        if n == 2 and "handle" in held:
            t = time.perf_counter()
            held.pop("handle").wait()
            now = time.perf_counter()
            rec["ckpt"].update(wait_s=now - t, total_s=now - held["t_call"])
        sync()
        entry["t_hooks"] = time.perf_counter() - t_in
        inner(self)
        if n == 1 and cfg.get("ckpt"):
            from salun_torch.ckpt import save_sharded

            sync()
            held["t_call"] = time.perf_counter()
            held["handle"] = save_sharded(cfg["ckpt"], self.state(),
                                          async_=True)
            call_s = time.perf_counter() - held["t_call"]
            rec["ckpt"] = {"call_s": call_s, **shard_digests(self)}
        sync()
        entry["t_out"] = time.perf_counter()

    def uninstall():
        trainers.SDOptimizer.step = inner
        for name, fn in saved:
            setattr(dist, name, fn)

    trainers.SDOptimizer.step = step
    return uninstall


def dp_launch(what: str, calls: list) -> tuple:
    """The calls ``[(module, argv[, hooks]), ...]`` in one torchrun launch
    of two ranks (this script's ``--dp-child``), CLI calls with ``--dp
    2`` (module ``"tp"``: :func:`tp_work`); fails unless the launch exits
    0, both ranks wrote each call's record on gloo, and both printed the
    same parameter digests (the training CLIs' replica check). Returns
    (each call's two records, rank 0's digests)."""
    import os
    import re

    base = WORK / "dp" / "ranks"
    base.mkdir(parents=True, exist_ok=True)
    out = base / what.replace(" ", "_")
    for old in base.glob(f"{out.name}.*.rank*.json"):
        old.unlink()
    spec = [{"module": c[0],
             "argv": list(c[1]) + ([] if c[0] in ("tp", "e24")
                                   else ["--dp", "2"]),
             "hooks": c[2] if len(c) > 2 else None} for c in calls]
    calls_file = base / f"{out.name}.calls.json"
    calls_file.write_text(json.dumps(spec))
    # two ranks on this host's 8 cores; gloo's pairs on the loopback device
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"),
           "--dp-child", str(out), str(calls_file)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"{what} --dp 2: no end within {DP_TIMEOUT} s")
    wall = time.perf_counter() - t0
    text = p.stdout + p.stderr
    out.with_suffix(".log").write_text(text)
    if p.returncode != 0:
        fail(f"{what} --dp 2 exited {p.returncode}:\n{text[-6000:]}")
    records = []
    for i, c in enumerate(spec):
        pair = []
        for r in (0, 1):
            path = base / f"{out.name}.{i}.rank{r}.json"
            if not path.exists():
                fail(f"{what} {c['module']} --dp 2: rank {r} wrote no record")
            pair.append(json.loads(path.read_text()))
            if pair[-1]["backend"] != "gloo":
                fail(f"{what} --dp 2: rank {r} on {pair[-1]['backend']}, "
                     f"want gloo (two ranks share one card)")
        records.append(pair)
    by_rank = {"0": [], "1": []}
    for r, d in re.findall(r"rank (\d): [^\n]*?digest ([0-9a-f]{16})", text):
        by_rank[r].append(d)
    if by_rank["0"] != by_rank["1"]:
        fail(f"{what} --dp 2: the replicas differ: {by_rank}")
    secs = ", ".join(f"{pair[0]['seconds']:.1f}" for pair in records)
    log(f"{what} --dp 2: {len(calls)} calls in one torchrun launch, "
        f"{wall:.1f} s wall (the calls {secs} s)")
    return records, by_rank["0"]


def _dp_launches(what: str, ranks: list, want: dict) -> dict:
    """Fails unless each rank launched each kernel as often as ``want``
    says; returns ``{"<what> rank r": launches}`` for the kernel table."""
    for rec in ranks:
        got = {k: rec["launches"][k] for k in want}
        extra = {k: n for k, n in rec["launches"].items()
                 if k not in want and n}
        if got != want or extra:
            fail(f"{what} --dp 2 rank {rec['rank']}: launches "
                 f"{rec['launches']}, the path implies {want}")
    log(f"{what} --dp 2: each rank's launches {want}, as the path implies "
        f"at half the batch")
    return {f"dp {what} rank {rec['rank']}": rec["launches"]
            for rec in ranks}


def _dp_report(what: str, ranks: list, steps: int, one_ms: float,
               dp_ms: float) -> None:
    red = ranks[0]["all_reduce"]
    per_step = red["ms"] / max(steps, 1)
    log(f"{what}: single process {one_ms:.3f} ms/step, --dp 2 {dp_ms:.3f} "
        f"ms/step (two ranks on one card, gloo); the all-reduce "
        f"{per_step:.3f} ms/step on rank 0 ({red['calls']} calls, "
        f"{red['bytes'] / 2**20:.1f} MiB in all, {red['ms']:.1f} ms); peak "
        f"memory rank 0 {ranks[0]['peak_bytes'] / 2**30:.3f} GiB, rank 1 "
        f"{ranks[1]['peak_bytes'] / 2**30:.3f} GiB; the call "
        f"{ranks[0]['seconds']:.1f} s")


def mask_agreement(a: dict, b: dict) -> float:
    n = sum(v.numel() for v in a.values())
    same = sum(int((a[k].float() == b[k].float()).sum()) for k in a)
    return same / n


def drift(a: dict, b: dict, rtol: float, atol: float) -> tuple:
    """(share of entries with |a − b| > atol + rtol·|a|, max |a − b|)."""
    bad = total = 0
    worst = 0.0
    for k, x in a.items():
        x, y = x.double(), b[k].double()
        d = (x - y).abs()
        bad += int((d > atol + rtol * x.abs()).sum())
        total += x.numel()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return bad / max(total, 1), worst


def dp_classification(device) -> dict:
    """Phase 7a: ``generate_mask`` and ``main_random --unlearn RL`` (phase
    4's argv, ResNet-18, bs 256, 1 epoch) at ``--dp 2``, held against
    phase 4's single-process files."""
    from salun_torch.ckpt import load_mask, load_state_dict

    data_dir, out_dir = WORK / "data", WORK / "out"
    model_path = WORK / "resnet18_seed0.pt"
    dp_dir = WORK / "dp" / "cls"
    shutil.rmtree(dp_dir, ignore_errors=True)
    common = ["--dataset", "cifar10", "--data", str(data_dir),
              "--arch", "resnet18", "--model_path", str(model_path),
              "--save_dir", str(dp_dir), "--batch_size", str(BATCH),
              "--num_indexes_to_replace", str(N_FORGET),
              "--class_to_replace", "-1", "--device", str(device.type)]
    rl_args = common + ["--unlearn", "RL",
                        "--mask_path", str(out_dir / "with_0.5.pt"),
                        "--unlearn_lr", str(LR),
                        "--unlearn_epochs", str(EPOCHS)]
    t0 = time.perf_counter()
    (ranks, rl_ranks, e24_ranks), digests = dp_launch("ResNet-18", [
        ("salun_torch.cli.generate_mask", common),
        ("salun_torch.cli.main_random", rl_args), ("e24", [])])
    by_path = _dp_launches("ResNet-18 generate_mask", ranks,
                           dict.fromkeys(_sd_kernels(), 0))
    one, two = (load_mask(str(d / "with_0.5.pt")) for d in (out_dir, dp_dir))
    ones = int(sum(int(v.sum()) for v in two.values()))
    n = sum(v.numel() for v in two.values())
    agree = mask_agreement(one, two)
    if ones != int(n * 0.5) or agree < DP_MASK_AGREE:
        fail(f"ResNet-18 --dp 2 mask: {ones} ones of {n}, agreement "
             f"{agree} with one process (bound {DP_MASK_AGREE})")
    log(f"ResNet-18 generate_mask --dp 2: exactly {ones} of {n} ones; "
        f"{agree:.6f} of the entries equal phase 4's single-process mask "
        f"(bound {DP_MASK_AGREE}); the call {ranks[0]['seconds']:.1f} s")

    ranks = rl_ranks
    loaders, _, _ = unlearn_loaders(rl_args)
    steps = EPOCHS * (len(loaders["forget"]) + len(loaders["retain"]))
    kernels = dict.fromkeys(_sd_kernels(), 0)
    kernels[K1_NAME] = steps
    by_path.update(_dp_launches("ResNet-18 RL", ranks, kernels))
    mask = load_mask(str(out_dir / "with_0.5.pt"))
    check_pinned(mask, model_path, dp_dir / "RL_checkpoint.pt",
                 "RL --dp 2")
    with open(out_dir / "RL_eval_result.json") as f:
        single = json.load(f)
    res = ranks[0]["result"]
    metrics = ("retain", "forget", "val", "test", "UA",
               "SVC_MIA_forget_efficacy")
    if any(ranks[1]["result"][k] != res[k] for k in metrics):
        fail("RL --dp 2: the ranks returned other metrics")
    check_metrics(res, "RL --dp 2")
    for k in ("retain", "forget", "val", "test", "UA"):
        if abs(res[k] - single[k]) > DP_POINTS:
            fail(f"RL --dp 2 {k} {res[k]} against {single[k]} single")
    theta0 = load_state_dict(str(model_path))
    one_w, two_w = (load_state_dict(str(d / "RL_checkpoint.pt"))
                    for d in (out_dir, dp_dir))
    keys = [k for k in theta0 if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    moved = sum(float((one_w[k].double() - theta0[k].double()).square()
                      .sum()) for k in keys) ** 0.5
    apart = sum(float((one_w[k].double() - two_w[k].double()).square()
                      .sum()) for k in keys) ** 0.5
    worst = max(float((one_w[k] - two_w[k]).abs().max()) for k in keys)
    if not apart <= DP_RL_RATIO * moved:
        fail(f"RL --dp 2 weights {apart} apart from the single-process "
             f"run's, which moved {moved} (bound {DP_RL_RATIO}x)")
    log(f"RL --dp 2 against phase 4's single-process RL: UA "
        f"{res['UA']:.2f}/{single['UA']:.2f} RA {res['retain']:.2f}/"
        f"{single['retain']:.2f} val {res['val']:.2f}/{single['val']:.2f} "
        f"TA {res['test']:.2f}/{single['test']:.2f} (bound {DP_POINTS} "
        f"points); the weights {apart:.4f} apart (L2), "
        f"{apart / moved:.3f} of the single run's update {moved:.4f} (bound "
        f"{DP_RL_RATIO}), max |Δ| {worst:.3e}; replica digests {digests}")
    one_ms = 1e3 * single["seconds"]["unlearn"] / steps
    dp_ms = 1e3 * res["seconds"]["unlearn"] / steps
    _dp_report("ResNet-18 RL", ranks, steps, one_ms, dp_ms)
    log(f"phase 7a (ResNet-18 --dp 2): {time.perf_counter() - t0:.3f} s")
    return by_path, e24_ranks


def dp_ddpm(device) -> dict:
    """Phase 7b: ``ddpm_train`` mask generation and 4 ``rl`` steps, then
    ``ddpm_sample``, at ``--dp 2`` on phase 5's data, checkpoint and mask,
    held against phase 5's single-process mask and samples and a 4-step
    single-process run."""
    import torch

    from salun_torch.ckpt import load_ddpm_states, load_mask
    from salun_torch.cli import ddpm_train
    from salun_torch.cli.ddpm_config import load_config
    from salun_torch.diffusion.sampling import timestep_sequence
    from salun_torch.diffusion.unet import attention_sites

    work = WORK / "ddpm"
    dp_dir = WORK / "dp" / "ddpm"
    shutil.rmtree(dp_dir, ignore_errors=True)
    bundle = load_config(str(DDPM_CONFIG))
    cfg = bundle.train
    sites = attention_sites(bundle.unet)
    common = ["--config", str(DDPM_CONFIG), "--data", str(work / "data"),
              "--label_to_forget", "0", "--ckpt_folder", str(work / "base"),
              "--device", str(device.type)]
    rel = Path("mask") / "0" / "with_0.5.pt"
    unlearn = common + ["--mode", "saliency_unlearn", "--method", "rl",
                        "--mask_path", str(work / "mask" / rel),
                        "--n_iters", str(DP_DDPM_ITERS)]
    t0 = time.perf_counter()
    single = ddpm_train.main(unlearn + ["--save_dir", str(dp_dir / "one")])
    torch.cuda.synchronize()
    (ranks, rl_ranks, sample_ranks), digests = dp_launch("DDPM", [
        ("salun_torch.cli.ddpm_train",
         common + ["--mode", "generate_mask",
                   "--save_dir", str(dp_dir / "mask")]),
        ("salun_torch.cli.ddpm_train",
         unlearn + ["--save_dir", str(dp_dir / "two")]),
        ("salun_torch.cli.ddpm_sample", [
            "--config", str(DDPM_SAMPLE_CONFIG), "--mode", "sample_classes",
            "--ckpt_folder", str(work / "unlearned"),
            "--classes", ",".join(map(str, DDPM_CLASSES)),
            "--n_samples_per_class", str(DDPM_SAMPLES),
            "--batch", str(DDPM_SAMPLES), "--timesteps", str(DDPM_STEPS),
            "--sample_type", "generalized", "--eta", "0",
            "--save_dir", str(dp_dir / "samples"),
            "--device", device.type])])
    n_batches = -(-DDPM_PER_CLASS // cfg.batch_size)
    k = list(_attention_kernels())
    zero = dict.fromkeys(_sd_kernels(), 0)
    by_path = _dp_launches("DDPM generate_mask", ranks, {
        **zero, **dict.fromkeys(k, sites * n_batches)})
    one = load_mask(str(work / "mask" / rel))
    two = load_mask(str(dp_dir / "mask" / rel))
    n = sum(v.numel() for v in two.values())
    ones = int(sum(int(v.sum()) for v in two.values()))
    agree = mask_agreement(one, two)
    if ones != n // 2 or agree < DP_MASK_AGREE:
        fail(f"DDPM --dp 2 mask: {ones} ones of {n}, agreement {agree} "
             f"(bound {DP_MASK_AGREE})")
    log(f"DDPM generate_mask --dp 2: exactly {ones} of {n} ones; {agree:.6f} "
        f"of the entries equal phase 5's single-process mask (bound "
        f"{DP_MASK_AGREE}); the call {ranks[0]['seconds']:.1f} s")

    ranks = rl_ranks
    it = DP_DDPM_ITERS
    by_path.update(_dp_launches("DDPM rl", ranks, {
        **zero, k[0]: 3 * sites * it, k[1]: 2 * sites * it,
        k[2]: 2 * sites * it}))
    theta0 = load_ddpm_states(str(work / "base" / "ckpts" / "ckpt.pth"))[0]
    a = load_ddpm_states(str(dp_dir / "one" / "ckpts" / "ckpt.pth"))[0]
    b = load_ddpm_states(str(dp_dir / "two" / "ckpts" / "ckpt.pth"))[0]
    for name, m in one.items():
        if not torch.equal(b[name][m == 0], theta0[name][m == 0]):
            fail(f"DDPM rl --dp 2 {name}: a masked-out weight left θ₀")
    lr = cfg.lr
    share, worst = drift(a, b, 0.0, lr / 10)
    if share > DP_ADAM_SHARE or worst > 2 * it * lr:
        fail(f"DDPM rl --dp 2: {share} of the weights beyond lr/10 of the "
             f"single-process run's, max |Δ| {worst} (bounds "
             f"{DP_ADAM_SHARE}, {2 * it * lr})")
    losses = ranks[0]["result"]["losses"]
    log(f"DDPM rl --dp 2 ({it} steps, bs {cfg.batch_size}): masked-out "
        f"weights θ₀ bitwise; weights beyond lr/10 of the single-process "
        f"run's: {share:.3e} (bound {DP_ADAM_SHARE}), max |Δ| {worst:.3e} "
        f"(bound {2 * it * lr:.1e}); losses {[round(x, 5) for x in losses]} "
        f"against {[round(x, 5) for x in single['losses']]}; replica "
        f"digests {digests}")
    _dp_report("DDPM rl", ranks, it, single["ms_per_step"],
               ranks[0]["result"]["ms_per_step"])

    ranks = sample_ranks
    n_steps = len(timestep_sequence(bundle.schedule.num_timesteps,
                                    DDPM_STEPS))
    by_path.update(_dp_launches("DDPM sample", ranks, {
        **zero, k[0]: sites * n_steps * len(DDPM_CLASSES)}))
    pngs = check_pngs("DDPM sample --dp 2", [
        (work / "samples" / str(c) / f"{i}.png",
         dp_dir / "samples" / str(c) / f"{i}.png")
        for c in DDPM_CLASSES for i in range(DDPM_SAMPLES)])
    log(f"DDPM sample --dp 2: {DDPM_SAMPLES * len(DDPM_CLASSES)} PNGs "
        f"against phase 5's single-process ones: {pngs}; "
        f"{ranks[0]['result']['seconds']:.3f} s (phase 5's call above)")
    log(f"phase 7b (DDPM --dp 2): {time.perf_counter() - t0:.3f} s")
    return by_path


def png_diffs(pairs) -> dict:
    """|Δ| of the 8-bit pixels of pairs of PNGs: mean, max and the share
    above 1 level, over all of them."""
    import numpy as np
    from PIL import Image

    d = []
    for a, b in pairs:
        x = np.asarray(Image.open(a), np.int16)
        y = np.asarray(Image.open(b), np.int16)
        if x.shape != y.shape:
            fail(f"{a} and {b} differ in shape")
        d.append(np.abs(x - y).ravel())
    d = np.concatenate(d)
    return {"mean": float(d.mean()), "max": int(d.max()),
            "above_1": float((d > 1).mean())}


def check_pngs(what: str, pairs) -> str:
    """Fails unless the pixels of ``pairs`` are within DP_PNG_MEAN on
    average and DP_PNG_MAX at most; returns a summary."""
    d = png_diffs(pairs)
    if d["mean"] > DP_PNG_MEAN or d["max"] > DP_PNG_MAX:
        fail(f"{what}: pixels off by {d['mean']} on average, {d['max']} at "
             f"most (bounds {DP_PNG_MEAN}, {DP_PNG_MAX})")
    return (f"pixels within {d['mean']:.4f} levels on average (bound "
            f"{DP_PNG_MEAN}), {d['max']} at most (bound {DP_PNG_MAX}), "
            f"{100 * d['above_1']:.3f}% off by more than 1")


def dp_sd(device, work: Path, ckpt: Path, mask_file: Path, cfg,
          csv: Path) -> dict:
    """Phase 7c: ``sd_train random_label`` at 512x512, global batch 2, 2
    steps, and ``sd_generate_images`` (phase 6's rows and settings) at
    ``--dp 2`` on phase 6's checkpoint, held against a single-process
    random_label run and phase 6's images. The random_label ranks leave
    their first step's gradients and their run under ``WORK/dp/sd`` for
    phase 8."""
    import gc

    import torch

    from salun_torch.ckpt import load_compvis_state_dict, load_sd_mask
    from salun_torch.cli import sd_train
    from salun_torch.diffusion.sampling import ldm_uniform_timesteps
    from salun_torch.sd.unet import kernel_sites

    dp_dir = WORK / "dp" / "sd"
    shutil.rmtree(dp_dir, ignore_errors=True)
    for c in range(10):
        write_png_folder(dp_dir / "data" / "imagenette2" / "train"
                         / f"n{c:08d}", DP_SD_PER_CLASS, 50 + c)
    rl = ["random_label", "--config", str(SD_CONFIG), "--ckpt_path",
          str(ckpt), "--data", str(dp_dir / "data"), "--image_size",
          str(SD_IMAGE), "--batch_size", str(DP_SD_BS), "--class_to_forget",
          "0", "--mask_path", str(mask_file), "--epochs", "1", "--lr",
          str(SD_LR), "--alpha", str(SD_ALPHA), "--train_method", "full",
          "--remat", "--device", device.type]
    t0 = time.perf_counter()
    single = sd_train.main(rl + ["--save_dir", str(dp_dir / "one")])
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    (ranks, gen_ranks, fsdp_ranks, tp_ranks), digests = dp_launch("SD", [
        ("salun_torch.cli.sd_train", rl + ["--save_dir", str(dp_dir / "two")],
         {"grads_out": str(dp_dir / "grads_dp.pt")}),
        ("salun_torch.cli.sd_generate_images", [
            "--prompts_path", str(csv), "--config", str(SD_CONFIG),
            "--ckpt_path", str(work / "rl" / "compvis.ckpt"),
            "--save_path", str(dp_dir / "images"), "--num_samples",
            str(SD_SAMPLES), "--ddim_steps", str(SD_STEPS),
            "--guidance_scale", str(SD_GUIDANCE), "--image_size",
            str(SD_IMAGE), "--device", device.type]),
        *sharded_state_calls(rl, ckpt, cfg)])
    sharded = (fsdp_ranks, tp_ranks, digests[1:])
    digests = digests[:1]
    steps = DP_SD_PER_CLASS // DP_SD_BS
    unet = kernel_sites(cfg.unet)
    enc = 2 * len(cfg.vae.ch_mult) * cfg.vae.num_res_blocks + 5
    dec = 2 * len(cfg.vae.ch_mult) * (cfg.vae.num_res_blocks + 1) + 5
    names = list(_sd_kernels())
    k2, k4, k2_re, k4_re = (unet["k2"], unet["k4"], unet["k2_remat"],
                            unet["k4_remat"])
    by_path = _dp_launches("SD random_label", ranks, dict(zip(names, (
        0, steps * (3 + 3 * k2 + 2 * k2_re), steps * 2 * k2,
        steps * 2 * k2, steps * (3 * enc + 3 * k4 + 2 * k4_re),
        steps * 2 * k4))))
    mask = load_sd_mask(str(mask_file), device)
    check_sd_pinned(ckpt, dp_dir / "two" / "compvis.ckpt", mask,
                    "random_label --dp 2", device)
    del mask
    prefix = "model.diffusion_model."
    a, b = (load_compvis_state_dict(str(dp_dir / d / "compvis.ckpt"))
            for d in ("one", "two"))
    a = {k: v for k, v in a.items() if k.startswith(prefix)}
    share, worst = drift(a, b, 0.0, SD_LR / 10)
    del a, b
    if share > DP_ADAM_SHARE or worst > 2 * steps * SD_LR:
        fail(f"SD random_label --dp 2: {share} of the U-Net beyond lr/10 "
             f"of the single-process run's, max |Δ| {worst} (bounds "
             f"{DP_ADAM_SHARE}, {2 * steps * SD_LR})")
    peak = sum(r["peak_bytes"] for r in ranks)
    log(f"SD random_label --dp 2 ({steps} steps, global bs {DP_SD_BS}, "
        f"{SD_IMAGE}x{SD_IMAGE}, remat): masked-out weights θ₀ bitwise; "
        f"U-Net weights beyond lr/10 of the single-process run's: "
        f"{share:.3e} (bound {DP_ADAM_SHARE}), max |Δ| {worst:.3e} (bound "
        f"{2 * steps * SD_LR:.1e}); both ranks' peaks {peak / 2**30:.3f} "
        f"GiB together ({peak / 1e9:.2f} GB of 80); replica digests "
        f"{digests}")
    _dp_report("SD random_label", ranks, steps, single["ms_per_step"],
               ranks[0]["result"]["ms_per_step"])

    ranks = gen_ranks
    n_ddim = len(ldm_uniform_timesteps(cfg.timesteps, SD_STEPS)[:-1])
    by_path.update(_dp_launches("SD generate_images", ranks, dict(zip(
        names, (0, SD_ROWS * (n_ddim * k2 + 1), 0, 0,
                SD_ROWS * (n_ddim * k4 + dec), 0)))))
    files = sorted(p.name for p in (work / "images").iterdir())
    pngs = check_pngs("SD generate_images --dp 2", [
        (work / "images" / f, dp_dir / "images" / f) for f in files])
    log(f"SD generate_images --dp 2: {len(files)} PNGs against phase 6's "
        f"single-process ones: {pngs}; {ranks[0]['result']['seconds']:.3f} "
        f"s (phase 6's call above)")
    log(f"phase 7c (SD --dp 2, with phase 8's calls in its launch): "
        f"{time.perf_counter() - t0:.3f} s")
    return by_path, sharded


# ------------------------------------------------------------------ phase 8


def _digest_pieces(pieces) -> int:
    from salun_torch.dist import context as dist_ctx

    return dist_ctx.digest(pieces)


def _rule_pieces(names, tensors, dims, parts: int, index: int,
                 perm_names=(), whole_on_first=True) -> list:
    """Rank ``index``'s pieces of whole ``tensors`` under a layout of
    ``parts`` ranks: the ``index``-th chunk along ``dims[name]`` (rows
    permuted first for ``perm_names``: the TP GEGLU), the whole tensors on
    index 0 only."""
    from salun_torch.dist.sharding import geglu_perm

    out = []
    for n, t in zip(names, tensors):
        d = dims.get(n)
        if d is None:
            if index == 0 or not whole_on_first:
                out.append(t)
            continue
        if n in perm_names:
            t = t[geglu_perm(t.shape[0], parts).to(t.device)]
        out.append(t.chunk(parts, d)[index])
    return out


def restore_whole(ckpt_dir: Path, names, shapes) -> tuple:
    """The sharded checkpoint read into whole CPU tensors in this process
    (no process group): ``{"unet", "adam"}`` and the seconds it took."""
    import torch

    from salun_torch.ckpt import restore_sharded

    like = {"unet": {n: torch.empty(shapes[n]) for n in names},
            "adam": {n: {"exp_avg": torch.empty(shapes[n]),
                         "exp_avg_sq": torch.empty(shapes[n]),
                         "step": torch.zeros(())} for n in names}}
    t0 = time.perf_counter()
    state = restore_sharded(str(ckpt_dir), like)
    return state, time.perf_counter() - t0


def _state_groups(state, names) -> dict:
    groups = {"unet": [state["unet"][n] for n in names]}
    for key in ("exp_avg", "exp_avg_sq", "step"):
        groups[key] = [state["adam"][n][key] for n in names]
    return groups


def expected_digests(groups, names, dims, parts, perm_names, device) -> list:
    """Each rank's digests of its pieces of the whole state ``groups``
    under a layout (:func:`_rule_pieces`), computed on the card."""
    out = []
    for index in range(parts):
        rank = {}
        for key, ts in groups.items():
            pieces = _rule_pieces(names, ts, dims if key != "step" else {},
                                  parts, index, perm_names)
            rank[key] = _digest_pieces([p.to(device) for p in pieces])
        out.append(rank)
    return out


def tp_work(cfg_path: str, rec: dict) -> None:
    """Phase 8's tensor-parallel call in a ``--dp-child`` rank (the group
    is up), at ``make_mesh(data=1, model=2)`` with TF32 off:

    - 8d: one random_label loss and backward of the full-width U-Net at
      global bs 2 (the forget forward against the no-grad pseudo forward,
      plus α times the remain forward against its noise), first on rank 0
      unsharded, then tensor-parallel on both ranks with the kernels
      counted; the loss and the gathered gradients against the unsharded
      ones;
    - 8c: the sharded exact k-th value of the 859.5M |θ − θ₀| split in two
      halves over the ranks against the one-card sort (rank 0), timed;
    - 8e: the FSDP run's checkpoint restored into this TP layout; the
      digests of this rank's pieces recorded.

    Fills ``rec``; TF32 is back on at the end."""
    import dataclasses

    import torch

    from salun_torch.ckpt import load_compvis_state_dict, restore_sharded
    from salun_torch.dist import fsdp, sharding
    from salun_torch.dist.mesh import make_mesh
    from salun_torch.dist.topk import kth_largest, kth_largest_sharded
    from salun_torch.sd.config import load_sd_config
    from salun_torch.sd.unet import SDUNet
    from salun_torch.utils.device import set_tf32

    cfg = json.loads(Path(cfg_path).read_text())
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mesh = make_mesh(data=1, model=2, device=dev)
    rank = mesh.rank
    set_tf32(False)
    unet_cfg = dataclasses.replace(load_sd_config(cfg["config"]).unet,
                                   remat=False)
    prefix = "model.diffusion_model."

    def unet_state(path):
        sd = load_compvis_state_dict(path)
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    theta0 = unet_state(cfg["ckpt"])

    def fresh():
        with torch.device(dev):
            u = SDUNet(unet_cfg)
        u.load_state_dict(theta0)
        return u

    gen = torch.Generator(device=dev).manual_seed(21)
    b = TP_BS

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    lat = cfg["latent"]
    z_f, z_p, z_r, noise = (rn(b, 4, lat, lat) for _ in range(4))
    ctx_f, ctx_p, ctx_r = (rn(b, 77, unet_cfg.context_dim) for _ in range(3))
    t_f = torch.randint(0, 1000, (b,), generator=gen, device=dev).float()
    t_r = torch.randint(0, 1000, (b,), generator=gen, device=dev).float()

    def loss_of(u):
        out_f = u(z_f, t_f, ctx_f)
        with torch.no_grad():
            pseudo = u(z_p, t_f, ctx_p)
        remain = (u(z_r, t_r, ctx_r) - noise).square().mean()
        return (out_f - pseudo).square().mean() + SD_ALPHA * remain

    kernels = _sd_kernels()
    ref = None
    if rank == 0:
        u = fresh()
        sync()
        t0 = time.perf_counter()
        loss = loss_of(u)
        loss.backward()
        sync()
        rec["ref_s"] = time.perf_counter() - t0
        ref = {"loss": float(loss),
               "grads": {n: p.grad for n, p in u.named_parameters()}}
        del u, loss
    torch.distributed.barrier()
    tp = fresh()
    sharding.shard_params(tp, mesh)
    specs = sharding.sd_unet_pspecs(tp)
    for f in kernels.values():
        f.launches = 0
    sync()
    t0 = time.perf_counter()
    loss = loss_of(tp)
    loss.backward()
    sync()
    rec["tp_s"] = time.perf_counter() - t0
    rec["launches"] = {k: f.launches for k, f in kernels.items()}
    rec["local_q"] = list(fsdp.local(
        tp.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight).shape)
    rec["n_sharded"] = sharding.count_sharded(specs)
    t0 = time.perf_counter()
    grads = sharding.full_grads(tp)
    rec["gather_grads_s"] = time.perf_counter() - t0
    if rank == 0:
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        worst, name = 0.0, None
        for n, want in ref["grads"].items():
            scale = float(want.abs().max())
            err = float((grads[n] - want).abs().max()) / (
                scale if scale > SHARDED_NOISE * top else top)
            if err > worst:
                worst, name = err, n
        rec["loss"] = [float(loss), ref["loss"]]
        rec["grad_err"] = {"worst": worst, "name": name}
    del grads, ref, loss
    for p in tp.parameters():
        p.grad = None
    if cuda:
        torch.cuda.empty_cache()

    # 8c: the exact k-th value of |θ − θ₀|, sharded and sorted
    theta = unet_state(cfg["theta"])
    n_total = sum(v.numel() for v in theta0.values())
    flat = torch.empty(n_total, device=dev)
    o = 0
    for k_, v in theta0.items():
        m = v.numel()
        flat[o:o + m] = (theta[k_].to(dev).reshape(-1)
                         - v.to(dev).reshape(-1)).abs()
        o += m
    del theta
    half = flat.chunk(2)[rank]
    rec["kth"] = []
    for k in cfg["ks"]:
        sync()
        t0 = time.perf_counter()
        got = kth_largest_sharded([half], k)
        sync()
        row = {"k": k, "sharded_ms": 1e3 * (time.perf_counter() - t0),
               "sharded_bits": int(got.view(torch.int32)),
               "value": float(got)}
        if rank == 0:
            t0 = time.perf_counter()
            want = kth_largest(flat, k)
            sync()
            row.update(sort_ms=1e3 * (time.perf_counter() - t0),
                       sort_bits=int(want.view(torch.int32)))
        rec["kth"].append(row)
    del flat, half
    if cuda:
        torch.cuda.empty_cache()

    # 8e: the FSDP checkpoint into this layout
    geglu = sharding._geglu_names(tp)
    names = cfg["names"]
    params = dict(tp.named_parameters())

    def like_of(p, n):
        if n in geglu:
            return torch.empty(p.shape, device=dev)
        return torch.zeros_like(p)

    like = {"unet": {n: (torch.empty(params[n].shape, device=dev)
                         if n in geglu else params[n].detach())
                     for n in names},
            "adam": {n: {"exp_avg": like_of(params[n], n),
                         "exp_avg_sq": like_of(params[n], n),
                         "step": torch.zeros(())} for n in names}}
    sync()
    t0 = time.perf_counter()
    restore_sharded(cfg["ckpt_dir"], like)
    sync()
    rec["restore_s"] = time.perf_counter() - t0
    dims = {n: d for n, d in specs.items() if d is not None}
    digests = {}
    for key, ts in _state_groups(like, names).items():
        pieces = []
        for n, t in zip(names, ts):
            if key != "step" and n in geglu:
                pieces += _rule_pieces([n], [t], dims, mesh.model, rank,
                                       geglu)
            elif fsdp.is_sharded(t) and dims.get(n) is not None:
                pieces.append(fsdp.local(t))
            elif rank == 0:
                pieces.append(fsdp.local(t))
        digests[key] = _digest_pieces(pieces)
    rec["restore_digests"] = digests
    set_tf32(True)


def offload_check(device, unet_sd: dict) -> None:
    """Phase 8f: OFFLOAD_STEPS Adam steps (lr 1e-5) over the full U-Net's
    parameters with the same gradients each step (a fixed function of the
    parameters), on the card and through ``offloaded`` (state in pinned
    host memory between steps): bitwise equal; each run's peak memory
    above the parameters and its ms a step."""
    import gc

    import torch

    from salun_torch.dist.host_offload import offloaded

    def run(wrap):
        params = [torch.nn.Parameter(v.to(device)) for v in unet_sd.values()]
        opt = wrap(torch.optim.Adam(params, lr=SD_LR))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(OFFLOAD_STEPS):
            for p in params:
                p.grad = torch.cos(p.detach() * (i + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            for p in params:
                p.grad = None
        peak = torch.cuda.max_memory_allocated() - base
        resident = torch.cuda.memory_allocated() - base
        out = [p.detach() for p in params]
        del opt
        return out, peak, resident, times

    plain, peak_a, res_a, ms_a = run(lambda o: o)
    off, peak_b, res_b, ms_b = run(lambda o: offloaded(o))
    same = all(torch.equal(a, b) for a, b in zip(plain, off))
    del plain, off
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        fail("offloaded Adam differs from Adam on the card")
    log(f"8f host offload: {OFFLOAD_STEPS} Adam steps over the U-Net's "
        f"{sum(v.numel() for v in unet_sd.values())} parameters bitwise "
        f"equal with the state in pinned host memory; peak above the "
        f"parameters {peak_a / 2**30:.3f} GiB on the card against "
        f"{peak_b / 2**30:.3f} GiB offloaded (drop "
        f"{(peak_a - peak_b) / 2**30:.3f} GiB); between steps "
        f"{res_a / 2**30:.3f} against {res_b / 2**30:.3f} GiB resident; "
        f"ms a step {[round(x, 3) for x in ms_a]} against "
        f"{[round(x, 3) for x in ms_b]} (streaming adds "
        f"{sum(ms_b[1:]) / len(ms_b[1:]) - sum(ms_a[1:]) / len(ms_a[1:]):.3f}"
        f" ms a step after the first)")


def tp_launches(tp: list, want: dict) -> None:
    for rec in tp:
        if rec["launches"] != want:
            fail(f"8d rank {rec['rank']}: launches {rec['launches']}, the "
                 f"step implies {want}")


def sharded_state_calls(rl: list, ckpt: Path, cfg) -> list:
    """Phase 8's two calls of phase 7c's launch, after 7c's own (whose
    random_label ranks dump their first step's gradients): 8a and 8b,
    ``sd_train`` with 7c's random_label argv ``rl`` and ``--fsdp`` (8e's
    async save inside it); then 8c, 8d and 8e's TP restore
    (:func:`tp_work`)."""
    import torch

    from salun_torch.sd.unet import SDUNet

    dp_dir = WORK / "dp" / "sd"
    fsdp_dir, ckpt_dir = dp_dir / "fsdp", dp_dir / "sharded_ckpt"
    with torch.device("meta"):
        meta = SDUNet(cfg.unet)
    n = sum(p.numel() for p in meta.parameters())
    tp_cfg = dp_dir / "tp.json"
    tp_cfg.write_text(json.dumps({
        "config": str(SD_CONFIG), "ckpt": str(ckpt),
        "theta": str(fsdp_dir / "compvis.ckpt"),
        "ks": [1, n // 8, n // 4, 3 * n // 8],  # in the half let move
        "latent": SD_IMAGE // 8, "ckpt_dir": str(ckpt_dir),
        "names": [k for k, _ in meta.named_parameters()]}))
    return [("salun_torch.cli.sd_train",
             rl + ["--fsdp", "--save_dir", str(fsdp_dir)],
             {"probe": True, "grads_ref": str(dp_dir / "grads_dp.pt"),
              "ckpt": str(ckpt_dir)}),
            ("tp", [str(tp_cfg)])]


def sharded_state_paths(device, ckpt: Path, mask_file: Path, cfg,
                        ranks: list, tp: list, digests: list) -> dict:
    """Phase 8's checks on the records of its two calls (``ranks``: the
    ``--fsdp`` run's, ``tp``: :func:`tp_work`'s; ``digests``: the
    ``--fsdp`` run's replica digests), with 8e's whole restore and 8f in
    this process between them. Returns the launches by path."""
    import gc

    import torch

    from salun_torch.ckpt import load_compvis_state_dict, load_sd_mask
    from salun_torch.dist import fsdp
    from salun_torch.dist.mesh import Mesh
    from salun_torch.dist.sharding import _geglu_names, sd_unet_pspecs
    from salun_torch.sd.unet import SDUNet, kernel_sites

    t_phase = time.perf_counter()
    dp_dir = WORK / "dp" / "sd"
    fsdp_dir, ckpt_dir = dp_dir / "fsdp", dp_dir / "sharded_ckpt"
    log(f"phase 8 (sharded state): the --fsdp call {ranks[0]['seconds']:.1f}"
        f" s, the TP call {tp[0]['seconds']:.1f} s of 7c's launch")
    # 8a
    for rec in ranks:
        pr = rec["probe"]
        if not (pr["all_gather_into_tensor"] and pr["reduce_scatter_tensor"]
                and pr["mesh_2x1"]["sizes"] == [2, 1]
                and pr["mesh_1x2"]["sizes"] == [1, 2]
                and {b for m in ("mesh_2x1", "mesh_1x2")
                     for b in pr[m]["backends"]} == {"gloo"}):
            fail(f"8a rank {rec['rank']}: gloo on the card: {pr}")
    log(f"8a collectives probe (gloo, CUDA tensors, two ranks on one "
        f"card): {ranks[0]['probe']}")

    # 8b: launches, shards, gradients, weights, time and memory
    steps = DP_SD_PER_CLASS // DP_SD_BS
    unet = kernel_sites(cfg.unet)
    enc = 2 * len(cfg.vae.ch_mult) * cfg.vae.num_res_blocks + 5
    names = list(_sd_kernels())
    k2, k4, k2_re, k4_re = (unet["k2"], unet["k4"], unet["k2_remat"],
                            unet["k4_remat"])
    by_path = _dp_launches("SD random_label --fsdp", ranks, dict(zip(names, (
        0, steps * (3 + 3 * k2 + 2 * k2_re), steps * 2 * k2,
        steps * 2 * k2, steps * (3 * enc + 3 * k4 + 2 * k4_re),
        steps * 2 * k4))))
    with torch.device("meta"):
        meta = SDUNet(cfg.unet)
    specs = fsdp.fsdp_pspecs(meta, Mesh(data=2, rank=0, device=device,
                                        backend="gloo"))
    shapes = {n: list(p.shape) for n, p in meta.named_parameters()}
    for rec in ranks:
        local = rec["result"]["fsdp_local_shapes"]
        bad = [n for n, d in specs.items()
               if local[n] != [f // 2 if i == d else f
                               for i, f in enumerate(shapes[n])]]
        if bad:
            fail(f"8b rank {rec['rank']}: shards off the rule: {bad[:5]}")
    n_sh = fsdp.count_sharded(specs)
    sharded_numel = sum(math.prod(shapes[n]) for n, d in specs.items()
                        if d is not None)
    worst = max(rec["grads"]["worst"] for rec in ranks)
    if not worst <= FSDP_GRAD_TOL:
        fail(f"8b gradients before Adam {[r['grads'] for r in ranks]} "
             f"against --dp 2's (bound {FSDP_GRAD_TOL})")
    mask = load_sd_mask(str(mask_file), device)
    check_sd_pinned(ckpt, fsdp_dir / "compvis.ckpt", mask,
                    "random_label --dp 2 --fsdp", device)
    del mask
    prefix = "model.diffusion_model."
    a, b = (load_compvis_state_dict(str(dp_dir / d / "compvis.ckpt"))
            for d in ("two", "fsdp"))
    a = {k: v for k, v in a.items() if k.startswith(prefix)}
    share, worst_w = drift(a, b, 0.0, SD_LR / 10)
    del a, b
    if share > DP_ADAM_SHARE or worst_w > 2 * steps * SD_LR:
        fail(f"8b --fsdp: {share} of the U-Net beyond lr/10 of the --dp 2 "
             f"run's, max |Δ| {worst_w} (bounds {DP_ADAM_SHARE}, "
             f"{2 * steps * SD_LR})")
    log(f"8b sd_train random_label --dp 2 --fsdp ({steps} steps, global bs "
        f"{DP_SD_BS}, {SD_IMAGE}x{SD_IMAGE}, remat): {n_sh} of "
        f"{len(specs)} U-Net tensors sharded ({sharded_numel} of "
        f"{sum(math.prod(v) for v in shapes.values())} parameters), each "
        f"rank's shards as the rule says; the first step's gradients before "
        f"Adam within {worst:.3e} of phase 7c's --dp 2 ones (bound "
        f"{FSDP_GRAD_TOL}; worst {ranks[0]['grads']['name']} on rank 0, "
        f"{ranks[0]['grads']['noise_tensors']} noise-level tensors); the "
        f"U-Net beyond lr/10 of phase 7c's: {share:.3e} (bound "
        f"{DP_ADAM_SHARE}), max |Δ| {worst_w:.3e}; masked-out weights θ₀ "
        f"bitwise; replica digests of the gathered U-Net {digests}")
    for rec in ranks:
        st = rec["steps"]
        fwd = [1e3 * (st[i]["t_in"] - st[i - 1]["t_out"])
               for i in range(1, len(st))]
        per = []
        for i in range(len(st)):
            prev = st[i - 1]["collectives"] if i else {
                "all_gather": [0, 0.0, 0], "reduce_scatter": [0, 0.0, 0]}
            cur = st[i]["collectives"]
            per.append({k: [cur[k][j] - prev[k][j] for j in range(3)]
                        for k in cur})
        log(f"8b rank {rec['rank']}: forward+backward ms of steps 2-{steps} "
            f"{[round(x, 1) for x in fwd]} (with the async save writing; "
            f"CLI ms/step {rec['result']['ms_per_step']:.1f}); per "
            f"step all-gathers (calls, ms, GB out) "
            f"{[(c['all_gather'][0], round(c['all_gather'][1], 1), round(c['all_gather'][2] / 1e9, 3)) for c in per]}"
            f", reduce-scatters "
            f"{[(c['reduce_scatter'][0], round(c['reduce_scatter'][1], 1), round(c['reduce_scatter'][2] / 1e9, 3)) for c in per]}"
            f" (each synchronised, so they run one at a time); peak memory "
            f"through step {steps} {st[-1]['peak_bytes'] / 2**30:.3f} GiB, "
            f"the call {rec['peak_bytes'] / 2**30:.3f} GiB (the writer's "
            f"gather included); the call {rec['seconds']:.1f} s")

    # 8e: the async save, restored whole here
    ck = [rec["ckpt"] for rec in ranks]
    nbytes = sum(c["bytes"] for c in ck)
    log(f"8e async save of the sharded U-Net and Adam state after step 1: "
        f"{nbytes / 1e9:.3f} GB from both ranks; the call returned in "
        f"{max(c['call_s'] for c in ck):.3f} s, done "
        f"{max(c['total_s'] for c in ck):.3f} s after it (step 2 ran "
        f"meanwhile; the wait at its end {max(c['wait_s'] for c in ck):.3f} s), "
        f"{nbytes / 1e9 / max(c['total_s'] for c in ck):.3f} GB/s")
    train = [n for n, p in meta.named_parameters()]
    gc.collect()
    torch.cuda.empty_cache()
    state, restore_s = restore_whole(ckpt_dir, train, shapes)
    groups = _state_groups(state, train)
    dims = {n: d for n, d in specs.items() if d is not None}
    want = expected_digests(groups, train, dims, 2, (), device)
    for rec, w in zip(ranks, want):
        got = {k: rec["ckpt"][k] for k in w}
        if got != w:
            fail(f"8e rank {rec['rank']}: the whole restore's pieces "
                 f"{w} differ from the state at the save {got}")
    log(f"8e restored whole in one process (no group) in {restore_s:.3f} s "
        f"({nbytes / 1e9 / restore_s:.3f} GB/s, the files warm in the "
        f"page cache): bitwise the state at the save on both ranks' "
        f"pieces (digests of the U-Net, both moments and the step counts)")
    tp_specs = {n: d for n, d in sd_unet_pspecs(meta).items()
                if d is not None}
    geglu = _geglu_names(meta)
    want_tp = expected_digests(groups, train, tp_specs, 2, geglu, device)
    unet_sd = {n: state["unet"][n] for n in train}
    del state, groups
    gc.collect()
    offload_check(device, unet_sd)
    del unet_sd
    gc.collect()
    torch.cuda.empty_cache()

    # 8c, 8d and 8e's TP restore
    n = sum(math.prod(v) for v in shapes.values())
    ks = json.loads((dp_dir / "tp.json").read_text())["ks"]
    r0 = tp[0]
    if not (abs(r0["loss"][0] - r0["loss"][1])
            <= TP_LOSS_TOL * abs(r0["loss"][1])
            and r0["grad_err"]["worst"] <= TP_GRAD_TOL):
        fail(f"8d TP loss {r0['loss']}, gradients {r0['grad_err']} (bounds "
             f"{TP_LOSS_TOL}, {TP_GRAD_TOL})")
    want_l = dict(zip(names, (0, 3 * k2, 2 * k2, 2 * k2, 3 * k4, 2 * k4)))
    tp_launches(tp, want_l)
    mc = cfg.unet.model_channels
    for rec in tp:
        if rec["local_q"] != [mc // 2, mc]:
            fail(f"8d rank {rec['rank']}: to_q's shard {rec['local_q']}")
    log(f"8d TP at make_mesh(1, 2), TF32 off, bs {TP_BS}: loss "
        f"{r0['loss'][0]!r} against {r0['loss'][1]!r} unsharded (bound "
        f"{TP_LOSS_TOL} relative); gathered gradients within "
        f"{r0['grad_err']['worst']:.3e} (bound {TP_GRAD_TOL}; worst "
        f"{r0['grad_err']['name']}); {r0['n_sharded']} tensors sharded, "
        f"half the heads a rank (to_q {r0['local_q']}); each rank's launches "
        f"{want_l}; the step {r0['tp_s']:.3f} s (both ranks on one card) "
        f"against {r0['ref_s']:.3f} s unsharded, the gradients' gather "
        f"{r0['gather_grads_s']:.3f} s; peak memory rank 0 "
        f"{r0['peak_bytes'] / 2**30:.3f} GiB, rank 1 "
        f"{tp[1]['peak_bytes'] / 2**30:.3f} GiB")
    for i, k in enumerate(ks):
        rows = [rec["kth"][i] for rec in tp]
        if not (rows[0]["sharded_bits"] == rows[1]["sharded_bits"]
                == rows[0]["sort_bits"]):
            fail(f"8c k = {k}: sharded {rows} against the sort")
        log(f"8c k = {k} of {n}: |θ − θ₀| of the --fsdp run {rows[0]['value']!r}"
            f" bitwise the one-card sort's; sharded (32 rounds over two "
            f"halves) {rows[0]['sharded_ms']:.3f} / {rows[1]['sharded_ms']:.3f}"
            f" ms, sort {rows[0]['sort_ms']:.3f} ms")
    for rec, w in zip(tp, want_tp):
        if rec["restore_digests"] != w:
            fail(f"8e rank {rec['rank']}: the TP restore's pieces "
                 f"{rec['restore_digests']} differ from the state at the "
                 f"save {w}")
    log(f"8e restored into the (1, 2) TP layout in "
        f"{max(r['restore_s'] for r in tp):.3f} s: bitwise the state at the "
        f"save on both ranks' pieces (GEGLU rows read whole, then "
        f"permuted)")
    by_path[f"sharded tp rank 0"] = tp[0]["launches"]
    by_path[f"sharded tp rank 1"] = tp[1]["launches"]
    shutil.rmtree(dp_dir, ignore_errors=True)
    log(f"phase 8's checks in this process: "
        f"{time.perf_counter() - t_phase:.3f} s")
    return by_path


# ------------------------------------------------------------------ phase 9


def shift_probe_child(out: str) -> None:
    """Phase 9a, one rank of ``torchrun --nproc_per_node 2 chip_smoke.py
    --shift-probe <out>``: the two ways to shift a CUDA tensor one rank
    round the ring over gloo (``all_to_all_single`` with split sizes, then
    ``batch_isend_irecv``), each against its exact value and written to
    ``<out>.rank<r>.json`` as soon as it is known, so that a rank which
    the second kills leaves the first on file."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from salun_torch.dist import multihost

    backend = multihost.initialize("cuda")
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"rank": r, "backend": backend}
    path = Path(f"{out}.rank{r}.json")
    x = torch.arange(6.0, device=dev) + 10 * r
    want = torch.arange(6.0) + 10 * ((r - 1) % n)
    split_in = [x.numel() if j == (r + 1) % n else 0 for j in range(n)]
    split_out = [x.numel() if j == (r - 1) % n else 0 for j in range(n)]
    for name in ("all_to_all_single", "batch_isend_irecv"):
        got = torch.empty_like(x)
        try:
            if name == "all_to_all_single":
                dist.all_to_all_single(got, x, split_out, split_in)
            else:
                for work in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, x, (r + 1) % n),
                        dist.P2POp(dist.irecv, got, (r - 1) % n)]):
                    work.wait()
            torch.cuda.synchronize()
            rec[name] = bool(torch.equal(got.cpu(), want))
        except Exception as e:  # recorded; the parent decides
            rec[name] = repr(e)
        path.write_text(json.dumps(rec))
    multihost.shutdown()


def shift_probe() -> dict:
    """Phase 9a: :func:`shift_probe_child` in a torchrun launch of its own
    (a crash there ends only that launch); returns each rank's record,
    with the launch's exit code."""
    import os

    base = WORK / "e24"
    base.mkdir(parents=True, exist_ok=True)
    out = base / "shift_probe"
    for old in base.glob("shift_probe.rank*.json"):
        old.unlink()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"),
           "--shift-probe", str(out)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        code, text = p.returncode, p.stdout + p.stderr
    except subprocess.TimeoutExpired as e:
        code, text = "timeout", f"{e.stdout or ''}{e.stderr or ''}"
    out.with_suffix(".log").write_text(str(text))
    recs = {}
    for r in (0, 1):
        path = base / f"shift_probe.rank{r}.json"
        recs[r] = json.loads(path.read_text()) if path.exists() else None
    why = [line.strip() for line in str(text).splitlines()
           if "what()" in line or "terminate called" in line
           or "Signal" in line][:3]
    return {"exit": code, "seconds": time.perf_counter() - t0,
            "ranks": recs, "why": why, "tail": str(text)[-2000:]}


def e24_work(rec: dict) -> dict:
    """Phase 9's call in a ``--dp-child`` rank (the group is up), TF32 off,
    each layer on both ranks and then on rank 0 alone in its one-process
    form (no mesh) on the whole input, which it broadcasts; each rank
    holds its share against it (max |Δ| over max(1, max|one-process|)):

    - 9b ``ring_attention`` over ``make_mesh(2, 1)``'s data axis at
      ``E24_RING``, half the sequence a rank, loss Σout²: the output and
      the gradients of q, k and v;
    - 9c ``moe_apply`` over the same axis at ``E24_MOE``, capacity
      T/(p·E)·1.25, loss Σy² + 0.01·aux: y, aux and the gradients of the
      router, the experts and x. The one-process form takes every token
      (its capacity the largest expert's load) and counts only the tokens
      the sharded run kept, which the function's own routing arithmetic
      names here;
    - 9d ``pipeline_apply`` of two stages over ``make_mesh(1, 2)``'s model
      axis at ``E24_PIPE``, remat, loss mean((out − y)²), against the
      stages applied in sequence: the output and each rank's stage
      gradients;
    - 9e one 9b forward on rank 0 inside ``maybe_profile``: the trace
      file's events and CUDA kernel events.

    Each side's forward + backward is timed (median of ``E24_REPS`` after
    one warm-up; both ranks at once on the one card). Returns the
    record's numbers; TF32 is as it was at the end."""
    import contextlib

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from salun_torch.dist import (expert_sharding, moe_apply, pipeline_apply,
                                  ring_attention, stack_stage_params,
                                  stage_sharding)
    from salun_torch.dist.mesh import make_mesh
    from salun_torch.utils import maybe_profile, set_tf32, tf32_settings

    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def ms_of(fn):
        fn()
        times = []
        for _ in range(E24_REPS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[len(times) // 2]

    def from_rank0(tensors):
        """Rank 0's ``tensors`` on both ranks (the others pass the same
        shapes), in place."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def err(got, want):
        return float((got.float() - want.float()).abs().max()) / max(
            1.0, float(want.abs().max()))

    def leaves(tensors):
        return [t.detach().clone().requires_grad_() for t in tensors]

    before = tf32_settings()
    set_tf32(False)
    dmesh = make_mesh(data=2, model=1, device=dev)
    pmesh = make_mesh(data=1, model=2, device=dev)
    rank = dmesh.rank
    gen = torch.Generator(device=dev).manual_seed(24)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    # 9b
    b, n, c = E24_RING
    qkv = [rn(b, n, c) for _ in range(3)]
    rows = dmesh.rows(n)

    def ring_step(inputs, mesh):
        ins = leaves(inputs)
        out = ring_attention(*ins, mesh)
        (out ** 2).sum().backward()
        return [out.detach()] + [t.grad for t in ins]

    shard = [t[:, rows] for t in qkv]
    got = ring_step(shard, dmesh)
    ring = {"ms": ms_of(lambda: ring_step(shard, dmesh)),
            "shape": [b, n, c], "block": rows.stop - rows.start}
    want = ring_step(qkv, None) if rank == 0 else [
        torch.empty_like(t) for t in [qkv[0]] * 4]
    if rank == 0:
        ring["one_ms"] = ms_of(lambda: ring_step(qkv, None))
    from_rank0(want)
    ring["err"] = dict(zip(("out", "dq", "dk", "dv"), (
        err(g, w[:, rows]) for g, w in zip(got, want))))
    rec["ring"] = ring
    del got, want

    # 9e: one 9b forward on rank 0 in maybe_profile (rank 1 joins its
    # collectives unprofiled)
    trace_dir = WORK / "e24" / "trace"
    if rank == 0:
        shutil.rmtree(trace_dir, ignore_errors=True)
    ctx = maybe_profile(str(trace_dir)) if rank == 0 \
        else contextlib.nullcontext()
    with ctx as path, torch.no_grad():
        ring_attention(*shard, dmesh)
        sync()
    if rank == 0:
        events = json.loads(Path(path).read_text())["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        names = sorted({e["name"] for e in kern}, key=len)
        rec["trace"] = {"path": str(path), "bytes": Path(path).stat().st_size,
                        "events": len(events), "kernel_events": len(kern),
                        "kernel_us": sum(e.get("dur", 0) for e in kern),
                        "kernels": names[:4]}
    del qkv, shard

    # 9c
    t_all, d, n_exp, hid = E24_MOE
    x = rn(t_all, d)
    gate_w = rn(d, n_exp, scale=d ** -0.5)
    experts = {"w1": rn(n_exp, d, hid, scale=d ** -0.5),
               "w2": rn(n_exp, hid, d, scale=hid ** -0.5)}
    cap = int(t_all / (2 * n_exp) * 1.25)
    esl, trows = expert_sharding(dmesh, n_exp), dmesh.rows(t_all)

    def expert(params, h):
        return F.gelu(h @ params["w1"]) @ params["w2"]

    def moe_step(mesh, ep, xs, capacity, keep=None):
        names = list(ep)
        *ps, g, xs = leaves([ep[k] for k in names] + [gate_w, xs])
        y, aux = moe_apply(expert, dict(zip(names, ps)), g, xs, mesh,
                           capacity=capacity)
        yk = y if keep is None else y * keep[:, None]
        ((yk ** 2).sum() + 0.01 * aux).backward()
        return [y.detach(), aux.detach(), g.grad, xs.grad] + [
            p.grad for p in ps]

    with torch.no_grad():  # which tokens each shard keeps, and the loads
        idx = torch.cat([torch.softmax(xc @ gate_w, -1).argmax(-1)
                         for xc in x.chunk(2)])  # each shard's own matmul
        onehot = F.one_hot(idx, n_exp).float()
        pos = torch.cat([(torch.cumsum(h, 0) * h).sum(-1) - 1
                         for h in onehot.chunk(2)])
        keep = (pos < cap).float()
        load = int(onehot.sum(0).max())
    local = {k: v[esl] for k, v in experts.items()}
    got = moe_step(dmesh, local, x[trows], cap)
    moe = {"ms": ms_of(lambda: moe_step(dmesh, local, x[trows], cap)),
           "shape": [t_all, d, n_exp, hid], "capacity": cap,
           "dropped": int(t_all - keep.sum()), "load_max": load}
    want = moe_step(None, experts, x, load, keep) if rank == 0 else [
        torch.empty_like(t) for t in (x, gate_w.new_zeros(()), gate_w, x,
                                      experts["w1"], experts["w2"])]
    if rank == 0:
        moe["one_ms"] = ms_of(lambda: moe_step(None, experts, x, load,
                                                 keep))
    from_rank0(want)
    want[0] = want[0] * keep[:, None]
    moe["err"] = {
        "y": err(got[0], want[0][trows]), "aux": err(got[1], want[1]),
        "d_gate": err(got[2], want[2]), "dx": err(got[3], want[3][trows]),
        "d_w1": err(got[4], want[4][esl]), "d_w2": err(got[5], want[5][esl])}
    moe["aux"] = [float(got[1]), float(want[1])]
    rec["moe"] = moe
    del got, want, x, experts, local

    # 9d
    d, hid, bs, micro = E24_PIPE
    stages = [{"w1": rn(d, hid, scale=d ** -0.5), "b1": rn(hid, scale=0.1),
               "w2": rn(hid, d, scale=hid ** -0.5)} for _ in range(2)]
    xp, yp = rn(bs, d), rn(bs, d)
    stacked = stack_stage_params(stages)
    ssl = stage_sharding(pmesh, 2)

    def mlp(params, h):
        return h + F.gelu(h @ params["w1"] + params["b1"]) @ params["w2"]

    def pipe_step():
        names = list(stacked)
        params = dict(zip(names, leaves([stacked[k][ssl] for k in names])))
        out = pipeline_apply(mlp, params, xp, pmesh, num_microbatches=micro)
        ((out - yp) ** 2).mean().backward()
        return [out.detach()] + [params[k].grad for k in names]

    def seq_step():
        names = list(stacked)
        ps = [dict(zip(names, leaves([s[k] for k in names])))
              for s in stages]
        h = xp
        for p in ps:
            h = mlp(p, h)
        ((h - yp) ** 2).mean().backward()
        return [h.detach()] + [torch.stack([p[k].grad for p in ps])
                               for k in names]

    got = pipe_step()
    pipe = {"ms": ms_of(pipe_step), "shape": [d, hid, bs, micro]}
    want = seq_step() if rank == 0 else [torch.empty_like(xp)] + [
        torch.empty_like(stacked[k]) for k in stacked]
    if rank == 0:
        pipe["one_ms"] = ms_of(seq_step)
    from_rank0(want)
    pipe["err"] = {"out": err(got[0], want[0])}
    for k, g, w in zip(stacked, got[1:], want[1:]):
        pipe["err"][f"d_{k}"] = err(g, w[ssl])
    pipe["stage"] = ssl.start
    rec["pipeline"] = pipe
    set_tf32(before["matmul_allow_tf32"])
    return {"tf32": tf32_settings()}


def parallel_layers_paths(probe: dict, ranks: list) -> None:
    """Phase 9's gates and lines: 9a's probe (its own launch, before 7a's)
    and the records of the call in 7a's launch (:func:`e24_work`)."""
    recs = probe["ranks"]
    a2a = [r and r.get("all_to_all_single") for r in recs.values()]
    p2p = [r and r.get("batch_isend_irecv", "no record: the rank died")
           for r in recs.values()]
    if a2a != [True, True]:
        fail(f"9a all_to_all_single with split sizes over gloo on CUDA "
             f"tensors: {a2a} (the ring shift's route); launch exit "
             f"{probe['exit']}:\n{probe['tail']}")
    log(f"9a ring shift on CUDA tensors over gloo (two ranks on the card, "
        f"a launch of its own, {probe['seconds']:.1f} s): "
        f"all_to_all_single with split sizes exact on both ranks (the "
        f"route, set in dist/collectives.py); batch_isend_irecv {p2p}, "
        f"launch exit {probe['exit']} {probe['why']}")
    for rec in ranks:
        if any(rec["launches"].values()):
            fail(f"9 rank {rec['rank']}: kernel launches {rec['launches']} "
                 f"on a path that runs none")
        for part in ("ring", "moe", "pipeline"):
            worst = max(rec[part]["err"].values())
            if not worst <= E24_TOL:
                fail(f"9 {part} rank {rec['rank']}: {rec[part]['err']} "
                     f"against the one-process form (bound {E24_TOL})")
    r0, r1 = ranks
    ring, moe, pipe = r0["ring"], r0["moe"], r0["pipeline"]

    def worst(part):
        return max(max(r[part]["err"].values()) for r in ranks)

    log(f"9b ring_attention {ring['shape']} ({ring['block']} a rank over "
        f"the data axis, TF32 off, {card_name_and_limit()}): output and "
        f"dq/dk/dv within "
        f"{worst('ring'):.3e} of the one-process form (bound {E24_TOL}; "
        f"rank 0 {ring['err']}); forward + backward {ring['ms']:.3f} / "
        f"{r1['ring']['ms']:.3f} ms on ranks 0 / 1 at once, one process "
        f"{ring['one_ms']:.3f} ms")
    log(f"9c moe_apply T, d, E, hidden {moe['shape']}, capacity "
        f"{moe['capacity']} (largest load {moe['load_max']} of "
        f"{moe['shape'][0]}; {moe['dropped']} tokens dropped by the "
        f"sharded run): y, aux and the gradients within {worst('moe'):.3e} "
        f"of the one-process form (bound {E24_TOL}; rank 0 {moe['err']}; "
        f"aux {moe['aux']}); forward + backward {moe['ms']:.3f} / "
        f"{r1['moe']['ms']:.3f} ms, one process {moe['one_ms']:.3f} ms")
    log(f"9d pipeline_apply d, hidden, B, M {pipe['shape']} (2 stages, "
        f"remat): output and each rank's stage gradients within "
        f"{worst('pipeline'):.3e} of the stages in sequence (bound "
        f"{E24_TOL}; rank 0 {pipe['err']}); forward + backward "
        f"{pipe['ms']:.3f} / {r1['pipeline']['ms']:.3f} ms, in sequence "
        f"{pipe['one_ms']:.3f} ms")
    tr = r0["trace"]
    if tr["kernel_events"] < 1:
        fail(f"9e maybe_profile's trace has no CUDA kernel event: {tr}")
    log(f"9e maybe_profile around one 9b forward on rank 0: "
        f"{tr['path']} ({tr['bytes']} bytes, {tr['events']} events, "
        f"{tr['kernel_events']} CUDA kernel events, {tr['kernel_us']:.1f} "
        f"µs of kernels; e.g. {tr['kernels']}); the call "
        f"{r0['seconds']:.1f} s of 7a's launch")


def main() -> None:
    if sys.argv[1:2] == ["--dp-child"]:
        dp_child(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--shift-probe"]:  # phase 9a's ranks
        shift_probe_child(sys.argv[2])
        return
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
    probe = shift_probe()
    cls_paths, e24_ranks = dp_classification(device)
    by_path.update(cls_paths)
    parallel_layers_paths(probe, e24_ranks)
    by_path.update(methods_paths(device, k1_ms[K1_NAME]))
    by_path.update(train_resume_path(device))
    by_path.update(cifar100_arch_paths(device, k1_ms))
    kth_on_card(device)
    by_path.update(remaining_methods_paths(device, k1_ms))
    by_path["ddpm"] = ddpm_path(device, attn_ms)
    by_path.update(dp_ddpm(device))
    by_path.update(ddpm_train_paths(device))
    ddpm_eval_path(device)
    by_path.update(stl10_path(device))
    by_path.update(sd_path(device, sd_attn_rows))
    by_path.update(scale_paths(device))
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
