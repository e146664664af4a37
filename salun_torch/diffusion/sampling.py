"""Diffusion samplers: DDIM (generalized), ancestral DDPM steps and PLMS
(counterpart of ``salun/diffusion/sampling.py``; reference
DDPM/functions/denoising.py:10-131 and SD/ldm/models/diffusion/plms.py,
same update equations).

Each chain is a Python loop over the (t_i, t_{i−1}) pairs; the per-step
noise comes from a ``torch.Generator`` or is injected (``noise``: one
tensor per step). CFG sampling runs one U-Net forward per step on the
doubled batch (``cfg_eps``). SD's DDIM uses the ldm grid
(:func:`ldm_uniform_timesteps`) and ᾱ₀ at the −1 boundary
(``final_alpha_bar``), and so does SD's PLMS (:func:`plms_steps`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from salun_torch.dist import context as dist_ctx
from salun_torch.utils.metrics import span

from .schedules import DiffusionSchedule
from .unet import ConditionalUNet, cfg_eps


def _seq_pairs(seq: Sequence[int]):
    """(t_i, t_{i−1}) pairs walked in reverse, with boundary −1."""
    seq = [int(s) for s in seq]
    seq_next = [-1] + seq[:-1]
    return list(zip(reversed(seq), reversed(seq_next)))


def _step_noise(noise, i, like, generator):
    if noise is not None:
        return noise[i].to(like.device, like.dtype)
    return dist_ctx.randn(like.shape, generator=generator, device=like.device,
                          dtype=like.dtype)


def _alpha(schedule, n, t, device):
    return schedule.alpha_bar(torch.full((n,), t, dtype=torch.long,
                                         device=device)).reshape(-1, 1, 1, 1)


def ldm_uniform_timesteps(num_ddpm_timesteps: int, num_steps: int) -> list:
    """The ldm 'uniform' DDIM grid ``range(0, T, T // S) + 1``
    (SD/ldm/modules/diffusionmodules/util.py make_ddim_timesteps; the DDPM
    workload's :func:`timestep_sequence` is not shifted). Use it with
    ``final_alpha_bar=alphas_cumprod[0]``."""
    c = num_ddpm_timesteps // num_steps
    return [s + 1 for s in range(0, num_ddpm_timesteps, c)]


def _chain_result(x, x0, xs, x0s, return_trajectory: bool):
    if return_trajectory:
        return x, torch.stack(xs), torch.stack(x0s)
    return x, x0


def generalized_steps(eps_fn: Callable, x: torch.Tensor, seq: Sequence[int],
                      schedule: DiffusionSchedule, *, eta: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      noise=None, final_alpha_bar: float = 1.0,
                      return_trajectory: bool = False):
    """DDIM chain (denoising.py:10-33). ``eps_fn(x, t_batch) -> eps``.
    ``final_alpha_bar`` is ᾱ at the −1 boundary: 1.0 (DDPM's
    compute_alpha) or, for ldm's DDIMSampler, ᾱ₀.
    Returns ``(x_final, last x0 prediction)``; with ``return_trajectory``
    ``(x_final, xs, x0_preds)``, each x_{t−1} and x0 prediction of the
    chain stacked ``[steps, B, C, H, W]`` (denoising.py:31,93)."""
    n = x.shape[0]
    x0_t = None
    xs, x0s = [], []
    for i, (t, t_next) in enumerate(_seq_pairs(seq)):
        with span("sample.transition"):
            at = _alpha(schedule, n, t, x.device)
            at_next = (_alpha(schedule, n, t_next, x.device) if t_next >= 0
                       else torch.full_like(at, final_alpha_bar))
            et = eps_fn(x, torch.full((n,), float(t), device=x.device))
            x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
            c1 = eta * torch.sqrt((1 - at / at_next) * (1 - at_next)
                                  / (1 - at))
            c2 = torch.sqrt((1 - at_next) - c1 ** 2)
            z = _step_noise(noise, i, x, generator)
            x = torch.sqrt(at_next) * x0_t + c1 * z + c2 * et
        if return_trajectory:
            xs.append(x)
            x0s.append(x0_t)
    return _chain_result(x, x0_t, xs, x0s, return_trajectory)


def ddpm_steps(eps_fn: Callable, x: torch.Tensor, seq: Sequence[int],
               schedule: DiffusionSchedule, *,
               generator: Optional[torch.Generator] = None, noise=None,
               return_trajectory: bool = False):
    """Ancestral sampling (denoising.py:36-69). Returns
    ``(x_final, last x0 prediction)``, or with ``return_trajectory`` the
    chain as :func:`generalized_steps` does."""
    n = x.shape[0]
    x0 = None
    xs, x0s = [], []
    for i, (t, t_next) in enumerate(_seq_pairs(seq)):
        with span("sample.transition"):
            at = _alpha(schedule, n, t, x.device)
            atm1 = _alpha(schedule, n, t_next, x.device)
            beta_t = 1.0 - at / atm1
            e = eps_fn(x, torch.full((n,), float(t), device=x.device))
            x0 = torch.sqrt(1.0 / at) * x - torch.sqrt(1.0 / at - 1.0) * e
            x0 = torch.clamp(x0, -1.0, 1.0)
            mean = (torch.sqrt(atm1) * beta_t * x0 + torch.sqrt(
                1.0 - beta_t) * (1.0 - atm1) * x) / (1.0 - at)
            z = _step_noise(noise, i, x, generator)
            mask = 1.0 if t > 0 else 0.0
            x = mean + mask * torch.exp(0.5 * torch.log(beta_t)) * z
        if return_trajectory:
            xs.append(x)
            x0s.append(x0)
    return _chain_result(x, x0, xs, x0s, return_trajectory)


def plms_steps(eps_fn: Callable, x: torch.Tensor, seq: Sequence[int],
               schedule: DiffusionSchedule,
               final_alpha_bar: Optional[float] = None):
    """PLMS chain (SD/ldm/models/diffusion/plms.py:268-382): pseudo linear
    multistep, deterministic (eta 0). The first step is a pseudo improved
    Euler step (eps at t and at t_next, averaged: two U-Net forwards);
    later steps combine the new eps with the last one to three by
    Adams-Bashforth of order 2, 3 and 4. So S steps cost S + 1 calls of
    ``eps_fn``. ``final_alpha_bar`` is ᾱ at the −1 boundary (ᾱ₀ for SD;
    None keeps the schedule's 1.0). At one step the bootstrap evaluates
    eps at t_next = −1, as the JAX chain does. Returns ``(x_final, last
    x0 prediction)``."""
    n = x.shape[0]

    def alpha(t):
        if t < 0 and final_alpha_bar is not None:
            return torch.full((n, 1, 1, 1), float(final_alpha_bar),
                              device=x.device)
        return _alpha(schedule, n, t, x.device)

    def x_prev_from(e, xt, at, a_prev):
        pred_x0 = (xt - torch.sqrt(1.0 - at) * e) / torch.sqrt(at)
        dir_xt = torch.sqrt(1.0 - a_prev) * e
        return torch.sqrt(a_prev) * pred_x0 + dir_xt, pred_x0

    hist = []  # the last eps values, newest first
    pred_x0 = None
    for t, t_next in _seq_pairs(seq):
        with span("sample.transition"):
            at, a_prev = alpha(t), alpha(t_next)
            e_t = eps_fn(x, torch.full((n,), float(t), device=x.device))
            if not hist:  # plms.py:363-367
                x_boot, _ = x_prev_from(e_t, x, at, a_prev)
                e_next = eps_fn(x_boot, torch.full((n,), float(t_next),
                                                   device=x.device))
                e_prime = (e_t + e_next) / 2.0
            elif len(hist) == 1:  # plms.py:368-379
                e_prime = (3 * e_t - hist[0]) / 2.0
            elif len(hist) == 2:
                e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12.0
            else:
                e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                           - 9 * hist[2]) / 24.0
            x, pred_x0 = x_prev_from(e_prime, x, at, a_prev)
        hist = [e_t] + hist[:2]
    return x, pred_x0


def timestep_sequence(num_timesteps: int, timesteps: Optional[int] = None,
                      skip_type: str = "uniform") -> list:
    """The sampled subsequence of [0, T) (runners/diffusion.py
    sample_image)."""
    T = num_timesteps
    timesteps = timesteps or T
    if skip_type == "uniform":
        return list(range(0, T, T // timesteps))
    if skip_type == "quad":
        seq = (np.linspace(0, np.sqrt(T * 0.8), timesteps) ** 2).astype(int)
        return [int(s) for s in seq]
    raise NotImplementedError(skip_type)


def sample_image(model: ConditionalUNet, schedule: DiffusionSchedule, *,
                 batch: int, image_size: int, channels: int,
                 classes: torch.Tensor, cond_scale: float = 2.0,
                 sample_type: str = "generalized",
                 timesteps: Optional[int] = None, skip_type: str = "uniform",
                 eta: float = 0.0, generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None, noise=None,
                 return_trajectory: bool = False):
    """The sampling pipeline (runners/diffusion.py sample_image): draw x_T
    (or take ``x_T``), run the chain with CFG eps, return x in [−1,1],
    NCHW; with ``return_trajectory`` ``(x, xs, x0_preds)``, the chain
    stacked ``[steps, B, C, H, W]``.

    Under a ``--dp`` mesh x_T is drawn for the whole batch and each rank
    runs the chain on its rows (``constrain_batch``; the per-step noise of
    ``ddpm_noisy`` is drawn whole and sliced too); every rank gets the whole
    result back."""
    seq = timestep_sequence(schedule.num_timesteps, timesteps, skip_type)
    device = classes.device
    if x_T is None:
        x_T = torch.randn((batch, channels, image_size, image_size),
                          generator=generator, device=device)
    x_T, classes = dist_ctx.constrain_batch((x_T, classes))
    if noise is not None and dist_ctx.active_mesh() is not None:
        noise = dist_ctx.constrain_batch(
            torch.stack([torch.as_tensor(z) for z in noise]), dim=1)

    def eps_fn(x, t):
        return cfg_eps(model, x, t, classes, cond_scale)

    with torch.no_grad(), dist_ctx.sharded(batch):
        if sample_type == "generalized":
            out = generalized_steps(eps_fn, x_T, seq, schedule, eta=eta,
                                    generator=generator, noise=noise,
                                    return_trajectory=return_trajectory)
        elif sample_type == "ddpm_noisy":
            out = ddpm_steps(eps_fn, x_T, seq, schedule,
                             generator=generator, noise=noise,
                             return_trajectory=return_trajectory)
        else:
            raise NotImplementedError(sample_type)
    if return_trajectory:
        x, xs, x0s = out
        return (dist_ctx.gather_rows(x, batch),
                dist_ctx.gather_rows(xs, batch, dim=1),
                dist_ctx.gather_rows(x0s, batch, dim=1))
    return dist_ctx.gather_rows(out[0], batch)
