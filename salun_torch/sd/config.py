"""Reference-YAML config ingestion for the SD workload: counterpart of
``salun/sd/config.py``.

The reference drives its whole model graph from ``v1-inference.yaml`` via
string-target instantiation (SD/configs/stable-diffusion/v1-inference.yaml,
ldm/util.py:73-89 instantiate_from_config). Here the same YAML shape maps
onto the typed dataclasses (SDUNetConfig / VAEConfig / CLIPTextConfig +
schedule parameters), so a user can point the CLI at a — possibly
modified — reference config file:

    python -m salun_torch.cli.sd_train ... --config path/to/v1-inference.yaml

Design: a strict translator, not a generic instantiator. Keys that select
capabilities this port implements are mapped; keys that would silently
change the math if ignored (use_scale_shift_norm, resblock_updown,
non-empty VAE attn_resolutions, …) raise loudly. Keys that are irrelevant
to inference-graph parity (logging, monitors, lr schedules) are ignored by
name. ``use_checkpoint`` becomes ``SDUNetConfig.remat``. The port computes
in fp32 only: ``dtype`` and ``use_fp16`` select nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

from .clip_text import CLIPTextConfig
from .unet import SDUNetConfig
from .vae import VAEConfig

_LDM = "ldm.models.diffusion.ddpm.LatentDiffusion"
_UNET = "ldm.modules.diffusionmodules.openaimodel.UNetModel"
_VAE = "ldm.models.autoencoder.AutoencoderKL"
_CLIP = "ldm.modules.encoders.modules.FrozenCLIPEmbedder"

# LatentDiffusion params that do not affect the inference/training graph we
# port (training-loop or logging knobs) — ignored silently.
_LDM_IGNORED = {
    "num_timesteps_cond", "log_every_t", "first_stage_key", "cond_stage_key",
    "image_size", "channels", "cond_stage_trainable", "conditioning_key",
    "monitor", "scheduler_config", "use_ema", "base_learning_rate",
    "ckpt_path", "load_only_unet", "ignore_keys", "make_it_fit",
    "use_positional_encodings", "reset_ema", "reset_num_ema_updates",
}

_UNET_IGNORED = {
    "image_size",        # marked 'unused' in the reference YAML itself
    "legacy",            # only changes dim_head when num_head_channels set
    "use_fp16",          # the port computes in fp32
}

# UNet params we accept only at their default/supported value.
_UNET_PINNED = {
    "use_spatial_transformer": (True,),
    "conv_resample": (True,),
    "dims": (2,),
    "num_classes": (None,),
    "num_head_channels": (-1,),
    "num_heads_upsample": (-1,),
    "use_scale_shift_norm": (False,),
    "resblock_updown": (False,),
    "use_new_attention_order": (False,),
    "n_embed": (None,),
    "disable_self_attentions": (None,),
    "num_attention_blocks": (None,),
}


@dataclass(frozen=True)
class SDYamlConfig:
    """Everything the port needs from a v1-inference-style YAML."""

    unet: SDUNetConfig
    vae: VAEConfig
    clip: CLIPTextConfig
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    scale_factor: float = 0.18215


def _check_target(cfg: dict, expected: str, where: str):
    target = cfg.get("target", expected)
    if target != expected:
        raise ValueError(
            f"{where}: unsupported target {target!r} (this port implements "
            f"{expected!r}; other graph classes are not available)")


def _pin(params: dict, pinned: dict, where: str):
    for k, allowed in pinned.items():
        if k in params and params[k] not in allowed:
            raise ValueError(
                f"{where}: {k}={params[k]!r} is not supported by this port "
                f"(supported: {allowed})")


def _unet_from_params(p: dict) -> SDUNetConfig:
    _pin(p, _UNET_PINNED, "unet_config")
    known = (set(_UNET_PINNED) | _UNET_IGNORED
             | {"in_channels", "out_channels", "model_channels",
                "num_res_blocks", "attention_resolutions", "channel_mult",
                "num_heads", "transformer_depth", "context_dim", "dropout",
                "use_checkpoint"})
    unknown = set(p) - known
    if unknown:
        raise ValueError(f"unet_config: unknown params {sorted(unknown)}")
    kw = dict(
        in_channels=int(p.get("in_channels", 4)),
        out_channels=int(p.get("out_channels", 4)),
        model_channels=int(p.get("model_channels", 320)),
        num_res_blocks=int(p.get("num_res_blocks", 2)),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=int(p.get("num_heads", 8)),
        transformer_depth=int(p.get("transformer_depth", 1)),
        context_dim=int(p.get("context_dim", 768)),
        dropout=float(p.get("dropout", 0.0)),
        # use_checkpoint → block-level remat (the reference trains with
        # True, v1-inference.yaml:43; identical math, fits bs 8 in HBM)
        remat=bool(p.get("use_checkpoint", False)),
    )
    return SDUNetConfig(**kw)


def _vae_from_params(p: dict, scale_factor: float) -> VAEConfig:
    unknown = set(p) - {"embed_dim", "ddconfig", "monitor", "lossconfig",
                        "ckpt_path", "image_key"}
    if unknown:
        raise ValueError(
            f"first_stage_config: unknown params {sorted(unknown)}")
    dd = p.get("ddconfig", {})
    dd_unknown = set(dd) - {
        "double_z", "z_channels", "resolution", "in_channels", "out_ch",
        "ch", "ch_mult", "num_res_blocks", "attn_resolutions", "dropout"}
    if dd_unknown:
        raise ValueError(
            f"first_stage_config.ddconfig: unknown keys {sorted(dd_unknown)}")
    if not dd.get("double_z", True):
        raise ValueError("first_stage_config: double_z=false unsupported "
                         "(KL autoencoder needs mean+logvar moments)")
    if tuple(dd.get("attn_resolutions", ())) != ():
        raise ValueError(
            "first_stage_config: non-empty attn_resolutions unsupported "
            "(sd-v1 uses attention only in the VAE mid block, which this "
            "port implements; per-resolution attention is not built)")
    if float(dd.get("dropout", 0.0)) != 0.0:
        raise ValueError("first_stage_config: nonzero VAE dropout "
                         "unsupported (sd-v1 uses 0.0)")
    kw = dict(
        ch=int(dd.get("ch", 128)),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=int(dd.get("num_res_blocks", 2)),
        z_channels=int(dd.get("z_channels", 4)),
        embed_dim=int(p.get("embed_dim", 4)),
        in_channels=int(dd.get("in_channels", 3)),
        out_channels=int(dd.get("out_ch", 3)),
        scale_factor=scale_factor,
    )
    return VAEConfig(**kw)


_CLIP_VITL = "openai/clip-vit-large-patch14"


def _clip_from_params(p: dict) -> CLIPTextConfig:
    unknown = set(p) - {"version", "device", "max_length"}
    if unknown:
        raise ValueError(
            f"cond_stage_config: unknown params {sorted(unknown)}")
    version = p.get("version", _CLIP_VITL)
    if version != _CLIP_VITL:
        # FrozenCLIPEmbedder's `version` selects the text-encoder
        # ARCHITECTURE (modules.py:230-266); only ViT-L/14 (the sd-v1
        # encoder, whose dims CLIPTextConfig defaults encode) is built.
        raise ValueError(
            f"cond_stage_config: version={version!r} unsupported (this "
            f"port implements {_CLIP_VITL!r})")
    kw = {}
    if "max_length" in p:
        kw["max_length"] = int(p["max_length"])
    return CLIPTextConfig(**kw)


def parse_sd_config(cfg: dict) -> SDYamlConfig:
    """Nested dict (yaml.safe_load of a v1-inference-style file) →
    :class:`SDYamlConfig`."""
    model = cfg.get("model", cfg)
    _check_target(model, _LDM, "model")
    p = model.get("params", {})

    unknown = (set(p) - _LDM_IGNORED
               - {"linear_start", "linear_end", "timesteps", "scale_factor",
                  "unet_config", "first_stage_config", "cond_stage_config"})
    if unknown:
        raise ValueError(f"model.params: unknown keys {sorted(unknown)}")

    unet_cfg = p.get("unet_config", {})
    _check_target(unet_cfg, _UNET, "unet_config")
    vae_cfg = p.get("first_stage_config", {})
    _check_target(vae_cfg, _VAE, "first_stage_config")
    clip_cfg = p.get("cond_stage_config", {})
    _check_target(clip_cfg, _CLIP, "cond_stage_config")

    scale_factor = float(p.get("scale_factor", 0.18215))
    return SDYamlConfig(
        unet=_unet_from_params(unet_cfg.get("params", {})),
        vae=_vae_from_params(vae_cfg.get("params", {}), scale_factor),
        clip=_clip_from_params(clip_cfg.get("params", {}) or {}),
        timesteps=int(p.get("timesteps", 1000)),
        linear_start=float(p.get("linear_start", 0.00085)),
        linear_end=float(p.get("linear_end", 0.0120)),
        scale_factor=scale_factor,
    )


def load_sd_config(path: str) -> SDYamlConfig:
    import yaml

    with open(path) as f:
        return parse_sd_config(yaml.safe_load(f))


def modules_from_config(cfg: SDYamlConfig, device="cpu", seed=None):
    """:class:`SDYamlConfig` → :class:`salun_torch.sd.ldm.SDModules` on
    ``device``."""
    from .ldm import SDModules

    return SDModules.create(
        unet_cfg=cfg.unet, vae_cfg=cfg.vae, clip_cfg=cfg.clip,
        num_timesteps=cfg.timesteps, linear_start=cfg.linear_start,
        linear_end=cfg.linear_end, device=device, seed=seed)
