"""AutoencoderKL (the SD first stage), counterpart of ``salun/sd/vae.py``.

SD/ldm/models/autoencoder.py:339-530 with the Encoder/Decoder of
ldm/modules/diffusionmodules/model.py:379-627 and the diagonal-Gaussian
posterior (ldm/modules/distributions/distributions.py:24-102), for the
sd-v1 config (ch 128, ch_mult [1,2,4,4], 2 res blocks, attention only in
the mid block, double_z, z=4, f=8). NCHW; module names are CompVis's
(``encoder.down.0.block.1.conv1``).

Kernels: every ResnetBlock's two GroupNorm → SiLU pairs and both
``norm_out`` → SiLU run as K4 (:class:`GroupNormSiLU`, eps 1e-6); the
mid-block attention (one head, D = channels = 512) runs as K2. The VAE is
frozen on every SalUn path and runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salun_torch.kernels.attention import scaled_dot_attention
from salun_torch.kernels.groupnorm_silu import GroupNormSiLU

EPS = 1e-6


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    in_channels: int = 3
    out_channels: int = 3
    scale_factor: float = 0.18215   # v1-inference.yaml scale_factor


def _conv3(cin, cout, stride=1, padding=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(32, in_ch, eps=EPS)
        self.conv1 = _conv3(in_ch, out_ch)
        self.norm2 = GroupNormSiLU(32, out_ch, eps=EPS)
        self.conv2 = _conv3(out_ch, out_ch)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial attention (model.py AttnBlock)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, eps=EPS)  # no SiLU: not K4
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)

        def seq(t):
            return t.reshape(b, c, h * w).transpose(1, 2).contiguous()

        o = scaled_dot_attention(seq(self.q(y)), seq(self.k(y)),
                                 seq(self.v(y)), scale=c ** -0.5)
        o = o.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(o)


class Downsample(nn.Module):
    """Asymmetric (0, 1) pad, then a stride-2 unpadded conv (model.py)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv3(c, c, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv3(c, c)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution of the encoder (``down.i``) or decoder (``up.i``)."""

    def __init__(self, blocks, resample=None, name=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = _conv3(cfg.in_channels, cfg.ch)
        levels = []
        block_in = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            last = i == len(cfg.ch_mult) - 1
            levels.append(_Level(blocks, None if last else
                                 Downsample(block_in), "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = GroupNormSiLU(32, block_in, eps=EPS)
        self.conv_out = _conv3(block_in, 2 * cfg.z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv3(cfg.z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            levels[i] = _Level(blocks, Upsample(block_in) if i else None,
                               "upsample")
        self.up = nn.ModuleList(levels)  # index = level, run from the top
        self.norm_out = GroupNormSiLU(32, block_in, eps=EPS)
        self.conv_out = _conv3(block_in, cfg.out_channels)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode_moments(self, x):
        """x in [−1, 1], NCHW → (mean, logvar) of the latent posterior."""
        mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_sample(self, x, noise):
        """A posterior sample (DiagonalGaussianDistribution.sample) with the
        standard-normal draw ``noise`` (shaped like the mean) injected."""
        mean, logvar = self.encode_moments(x)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
