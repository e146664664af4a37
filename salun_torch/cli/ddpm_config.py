"""YAML → typed DDPM configs (counterpart of ``salun/cli/ddpm_config.py``):
``configs/ddpm/*.yml`` (and the reference's field layout) → the U-Net
config, the diffusion schedule and the train config, with the same
defaults and overrides."""

from __future__ import annotations

from dataclasses import dataclass

import yaml

from salun_torch.diffusion import DiffusionSchedule, UNetConfig
from salun_torch.diffusion.runner import DDPMTrainConfig


@dataclass
class DDPMConfigBundle:
    unet: UNetConfig
    schedule: DiffusionSchedule
    train: DDPMTrainConfig
    dataset: str
    raw: dict


def load_config(path: str, **overrides) -> DDPMConfigBundle:
    """Read ``path``; each non-None ``overrides`` entry that names a
    ``DDPMTrainConfig`` field replaces it."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    data = raw.get("data", {})
    model = raw.get("model", {})
    diff = raw.get("diffusion", {})
    training = raw.get("training", {})
    optim = raw.get("optim", {})
    sampling = raw.get("sampling", {})

    unet = UNetConfig(
        ch=model.get("ch", 128),
        out_ch=model.get("out_ch", data.get("channels", 3)),
        ch_mult=tuple(model.get("ch_mult", (1, 2, 2, 2))),
        num_res_blocks=model.get("num_res_blocks", 2),
        attn_resolutions=tuple(model.get("attn_resolutions", (16,))),
        dropout=model.get("dropout", 0.1),
        in_channels=data.get("channels", 3),
        image_size=data.get("image_size", 32),
        n_classes=data.get("n_classes", 10),
        cond_drop_prob=model.get("cond_drop_prob", 0.1),
        resamp_with_conv=model.get("resamp_with_conv", True),
    )
    schedule = DiffusionSchedule.create(
        beta_schedule=diff.get("beta_schedule", "linear"),
        beta_start=diff.get("beta_start", 1e-4),
        beta_end=diff.get("beta_end", 2e-2),
        num_diffusion_timesteps=diff.get("num_diffusion_timesteps", 1000),
        var_type=model.get("var_type", "fixedlarge"),
    )
    train = DDPMTrainConfig(
        n_iters=training.get("n_iters", 1000),
        batch_size=training.get("batch_size", 128),
        lr=optim.get("lr", 2e-4),
        beta1=optim.get("beta1", 0.9),
        eps=optim.get("eps", 1e-8),
        grad_clip=optim.get("grad_clip", 1.0),
        ema=model.get("ema", False),
        ema_rate=model.get("ema_rate", 0.9999),
        alpha=training.get("alpha", 1.0),
        method=training.get("method", "rl"),
        cond_scale=sampling.get("cond_scale", 2.0),
        gamma=training.get("gamma", 1.0),
        lmbda=training.get("lmbda", 100.0),
        snapshot_freq=training.get("snapshot_freq", 1000),
        log_freq=training.get("log_freq", 100),
        cond_drop_prob=model.get("cond_drop_prob", 0.1),
        random_flip=data.get("random_flip", True),
    )
    for k, v in overrides.items():
        if v is not None and hasattr(train, k):
            setattr(train, k, v)
    return DDPMConfigBundle(unet=unet, schedule=schedule, train=train,
                            dataset=data.get("dataset", "cifar10"), raw=raw)
