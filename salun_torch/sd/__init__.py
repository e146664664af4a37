"""The Stable Diffusion v1 workload of the port (counterpart of
``salun/sd``): U-Net, VAE and CLIP text encoder as ``nn.Module``s under
CompVis names, the LatentDiffusion wrapper, the yaml config, Imagenette
and NSFW-folder data, the trainers (mask generation, random_label,
gradient ascent, nsfw_removal, proximal, ESD), the LDM lr schedules and
the diffusers export of the U-Net."""

from .clip_text import CLIPTextConfig, CLIPTextModel, tokenize
from .diffusers_export import (export_diffusers_unet, import_diffusers_unet,
                               save_diffusers_unet)
from .ldm import SDModules, sd_schedule
from .lr_schedules import lambda_linear, warmup_cosine, warmup_cosine2
from .unet import SDUNet, SDUNetConfig
from .vae import AutoencoderKL, VAEConfig

__all__ = ["AutoencoderKL", "CLIPTextConfig", "CLIPTextModel", "SDModules",
           "SDUNet", "SDUNetConfig", "VAEConfig", "export_diffusers_unet",
           "import_diffusers_unet", "lambda_linear", "save_diffusers_unet",
           "sd_schedule", "tokenize", "warmup_cosine", "warmup_cosine2"]
