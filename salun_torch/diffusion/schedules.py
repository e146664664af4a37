"""Diffusion beta schedules and derived quantities (counterpart of
``salun/diffusion/schedules.py``; reference DDPM/runners/diffusion.py:
36-99).

The tables are computed in float64 with numpy, then cast to float32
tensors; :meth:`DiffusionSchedule.to` moves them to a device once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def get_beta_schedule(beta_schedule: str, *, beta_start: float,
                      beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor            # [T] float32
    alphas_cumprod: torch.Tensor   # [T]
    logvar: torch.Tensor           # [T] sampling log-variance

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, beta_schedule="linear", beta_start=1e-4, beta_end=2e-2,
               num_diffusion_timesteps=1000, var_type="fixedlarge"):
        betas64 = get_beta_schedule(
            beta_schedule, beta_start=beta_start, beta_end=beta_end,
            num_diffusion_timesteps=num_diffusion_timesteps)
        acp = np.cumprod(1.0 - betas64)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        posterior_var = betas64 * (1.0 - acp_prev) / (1.0 - acp)
        if var_type == "fixedlarge":
            logvar = np.log(betas64)
        elif var_type == "fixedsmall":
            logvar = np.log(np.maximum(posterior_var, 1e-20))
        else:
            raise NotImplementedError(var_type)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        return cls(betas=f32(betas64), alphas_cumprod=f32(acp),
                   logvar=f32(logvar))

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(self.betas.to(device),
                                 self.alphas_cumprod.to(device),
                                 self.logvar.to(device))

    def alpha_bar(self, t: torch.Tensor) -> torch.Tensor:
        """ᾱ_t with the boundary ᾱ_{-1} = 1 (denoising.py compute_alpha)."""
        acp = torch.cat([torch.ones(1, dtype=torch.float32,
                                    device=self.alphas_cumprod.device),
                         self.alphas_cumprod])
        return acp[t.long() + 1]


def q_sample(x0, t, noise, schedule: DiffusionSchedule):
    """Forward process x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε (losses.py:31-33)."""
    a = schedule.alphas_cumprod[t.long()].reshape(-1, 1, 1, 1)
    return x0 * torch.sqrt(a) + noise * torch.sqrt(1.0 - a)


def antithetic_timesteps(batch: int, num_timesteps: int, *,
                         generator: torch.Generator = None, base=None,
                         device=None):
    """t and T−t−1 paired (runners/diffusion.py:222-226).

    Like the reference, draws ``batch//2 + 1`` base samples (one extra for
    even batches, dropped by the ``[:batch]`` slice), not ``ceil(batch/2)``.
    ``base`` injects those draws; otherwise they come from ``generator``.
    """
    if base is None:
        dev = generator.device if generator is not None else device
        base = torch.randint(0, num_timesteps, (batch // 2 + 1,),
                             generator=generator, device=dev)
    base = torch.as_tensor(base).long()
    if base.shape != (batch // 2 + 1,):
        raise ValueError(f"{tuple(base.shape)} base draws for batch {batch}")
    return torch.cat([base, num_timesteps - base - 1])[:batch]


def data_transform(x, rescaled: bool = True):
    """[0,1] → [−1,1] (DDPM/datasets/__init__.py:241-255)."""
    return 2.0 * x - 1.0 if rescaled else x


def inverse_data_transform(x, rescaled: bool = True):
    y = (x + 1.0) / 2.0 if rescaled else x
    return torch.clamp(y, 0.0, 1.0)
