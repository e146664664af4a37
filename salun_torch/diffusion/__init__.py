from .ema import ema_init, ema_update
from .losses import eps_mse
from .sampling import ddpm_steps, generalized_steps, sample_image
from .schedules import (DiffusionSchedule, antithetic_timesteps,
                        data_transform, get_beta_schedule,
                        inverse_data_transform, q_sample)
from .unet import ConditionalUNet, UNetConfig, cfg_eps, init_unet

__all__ = ["ConditionalUNet", "DiffusionSchedule", "UNetConfig",
           "antithetic_timesteps", "cfg_eps", "data_transform",
           "ddpm_steps", "ema_init", "ema_update", "eps_mse",
           "generalized_steps", "get_beta_schedule", "init_unet",
           "inverse_data_transform", "q_sample", "sample_image"]
