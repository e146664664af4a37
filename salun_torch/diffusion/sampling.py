"""Diffusion samplers: DDIM (generalized) and ancestral DDPM steps
(counterpart of ``salun/diffusion/sampling.py``; reference
DDPM/functions/denoising.py:10-131, same update equations).

Each chain is a Python loop over the (t_i, t_{i−1}) pairs; the per-step
noise comes from a ``torch.Generator`` or is injected (``noise``: one
tensor per step). CFG sampling runs one U-Net forward per step on the
doubled batch (``cfg_eps``). SD's DDIM uses the ldm grid
(:func:`ldm_uniform_timesteps`) and ᾱ₀ at the −1 boundary
(``final_alpha_bar``); ``plms_steps`` waits (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

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
    return torch.randn(like.shape, generator=generator, device=like.device,
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
        at = _alpha(schedule, n, t, x.device)
        at_next = (_alpha(schedule, n, t_next, x.device) if t_next >= 0
                   else torch.full_like(at, final_alpha_bar))
        et = eps_fn(x, torch.full((n,), float(t), device=x.device))
        x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        c1 = eta * torch.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
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
        at = _alpha(schedule, n, t, x.device)
        atm1 = _alpha(schedule, n, t_next, x.device)
        beta_t = 1.0 - at / atm1
        e = eps_fn(x, torch.full((n,), float(t), device=x.device))
        x0 = torch.sqrt(1.0 / at) * x - torch.sqrt(1.0 / at - 1.0) * e
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean = (torch.sqrt(atm1) * beta_t * x0
                + torch.sqrt(1.0 - beta_t) * (1.0 - atm1) * x) / (1.0 - at)
        z = _step_noise(noise, i, x, generator)
        mask = 1.0 if t > 0 else 0.0
        x = mean + mask * torch.exp(0.5 * torch.log(beta_t)) * z
        if return_trajectory:
            xs.append(x)
            x0s.append(x0)
    return _chain_result(x, x0, xs, x0s, return_trajectory)


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
    stacked ``[steps, B, C, H, W]``."""
    seq = timestep_sequence(schedule.num_timesteps, timesteps, skip_type)
    device = classes.device
    if x_T is None:
        x_T = torch.randn((batch, channels, image_size, image_size),
                          generator=generator, device=device)

    def eps_fn(x, t):
        return cfg_eps(model, x, t, classes, cond_scale)

    with torch.no_grad():
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
    return out if return_trajectory else out[0]
