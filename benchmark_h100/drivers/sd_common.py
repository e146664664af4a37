"""Stable Diffusion v1 for the SD cells: the system under test's modules,
the plain reference's, both with the same seeded weights, and the work of
one forward of each model, counted on the reference at the cell's shapes.
"""

from __future__ import annotations

import torch

from benchmark_h100.harness import flops, weights
from benchmark_h100.reference import sd_v1

STREAMS = {"unet": 0, "vae": 1, "clip": 2}


def build_program(cfg: dict, device, seed: int):
    """``salun_torch.sd.ldm.SDModules`` at the configuration's sizes, made
    empty on the device and filled from the seed; VAE and CLIP frozen."""
    from salun_torch.sd.clip_text import CLIPTextConfig, CLIPTextModel
    from salun_torch.sd.ldm import SDModules, sd_schedule
    from salun_torch.sd.unet import SDUNet, SDUNetConfig
    from salun_torch.sd.vae import AutoencoderKL, VAEConfig

    u, v, c, s = cfg["unet"], cfg["vae"], cfg["clip"], cfg["schedule"]
    unet_cfg = SDUNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        model_channels=u["model_channels"],
        num_res_blocks=u["num_res_blocks"],
        attention_resolutions=tuple(u["attention_resolutions"]),
        channel_mult=tuple(u["channel_mult"]), num_heads=u["num_heads"],
        transformer_depth=u["transformer_depth"],
        context_dim=u["context_dim"], remat=bool(u["use_checkpoint"]))
    vae_cfg = VAEConfig(ch=v["ch"], ch_mult=tuple(v["ch_mult"]),
                        num_res_blocks=v["num_res_blocks"],
                        z_channels=v["z_channels"], embed_dim=v["embed_dim"],
                        in_channels=v["in_channels"],
                        out_channels=v["out_ch"],
                        scale_factor=v["scale_factor"])
    clip_cfg = CLIPTextConfig(vocab_size=c["vocab_size"],
                              hidden_size=c["hidden_size"],
                              num_layers=c["num_layers"],
                              num_heads=c["num_heads"],
                              max_length=c["max_length"])
    with torch.device("meta"):
        parts = {"unet": SDUNet(unet_cfg), "vae": AutoencoderKL(vae_cfg),
                 "clip": CLIPTextModel(clip_cfg)}
    for name, part in parts.items():
        part.to_empty(device=device)
        weights.fill(part, seed, STREAMS[name])
    for frozen in (parts["vae"], parts["clip"]):
        frozen.requires_grad_(False).eval()
    schedule = sd_schedule(s["timesteps"], s["linear_start"],
                           s["linear_end"]).to(device)
    return SDModules(parts["unet"], parts["vae"], parts["clip"], schedule,
                     v["scale_factor"])


def build_reference(cfg: dict, device, seed: int):
    """The plain reference with the same seeded weights, frozen."""
    with torch.device("meta"):
        ref = sd_v1.StableDiffusion(cfg)
    ref.to_empty(device=device)
    for name in STREAMS:
        weights.fill(getattr(ref, name), seed, STREAMS[name])
    return ref.requires_grad_(False).eval()


def meta_reference(cfg: dict):
    with torch.device("meta"):
        return sd_v1.StableDiffusion(cfg)


def unet_work(ref, cfg: dict, rows: int, latent: int, grad: bool):
    u = cfg["unet"]
    return flops.count(lambda: ref.unet(
        flops.meta((rows, u["in_channels"], latent, latent)),
        flops.meta((rows,)),
        flops.meta((rows, cfg["clip"]["max_length"], u["context_dim"]))),
        grad)


def encode_work(ref, cfg: dict, rows: int, size: int):
    return flops.count(lambda: ref.vae.moments(
        flops.meta((rows, cfg["vae"]["in_channels"], size, size))), False)


def decode_work(ref, cfg: dict, rows: int, latent: int):
    return flops.count(lambda: ref.vae.decode(
        flops.meta((rows, cfg["vae"]["embed_dim"], latent, latent))), False)


def text_work(ref, cfg: dict, rows: int):
    return flops.count(lambda: ref.clip(flops.meta(
        (rows, cfg["clip"]["max_length"]), torch.long)), False)
