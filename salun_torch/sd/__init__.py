"""The Stable Diffusion v1 workload of the port (counterpart of
``salun/sd``): U-Net, VAE and CLIP text encoder as ``nn.Module``s under
CompVis names, the LatentDiffusion wrapper, the yaml config, Imagenette
and NSFW-folder data and the trainers (mask generation, random_label,
gradient ascent, nsfw_removal, proximal, ESD)."""

from .clip_text import CLIPTextConfig, CLIPTextModel, tokenize
from .ldm import SDModules, sd_schedule
from .unet import SDUNet, SDUNetConfig
from .vae import AutoencoderKL, VAEConfig

__all__ = ["AutoencoderKL", "CLIPTextConfig", "CLIPTextModel", "SDModules",
           "SDUNet", "SDUNetConfig", "VAEConfig", "sd_schedule", "tokenize"]
