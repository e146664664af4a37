"""Class-conditional CFG U-Net (DDPM) in PyTorch, NCHW (counterpart of
``salun/diffusion/unet.py``; reference ``Conditional_Model``,
DDPM/models/diffusion.py:195-413).

Module names are the reference's (``temb.dense.0``, ``down.1.attn.0.q``,
``mid.block_1``, ``up.3.upsample.conv``, ``classes_emb``,
``null_classes_emb``, …), which ``salun.ckpt.export_ddpm_unet`` also
writes, so a reference ``ckpt.pth`` loads with ``strict=True`` and masks
are in the reference format.

GroupNorm(32, eps 1e-6) is followed by a separate SiLU, as in ``salun``
(the fused GroupNorm+SiLU kernel K4 is not wired in there either). Every
``AttnBlock`` goes through ``salun_torch.kernels.attention`` (K2 forward,
K3a/K3b backward on a CUDA tensor). Randomness (cond-drop, dropout) comes
from an explicit ``torch.Generator``; cond-drop can also be injected as a
``keep_mask``. On a shard of a ``--dp`` batch the draws are the global
batch's, sliced (``salun_torch.dist.context.rand``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salun_torch.dist import context as dist_ctx
from salun_torch.kernels.attention import scaled_dot_attention


@dataclass(frozen=True)
class UNetConfig:
    """Model block of the reference YAML (configs/ddpm/*.yml)."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.1
    in_channels: int = 3
    image_size: int = 32
    n_classes: int = 10
    cond_drop_prob: float = 0.1
    resamp_with_conv: bool = True


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding (models/diffusion.py:17-35)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        # concat(temb, cemb) projection added per channel
        # (diffusion.py:126-131)
        self.temb_cemb_proj = nn.Linear(emb_ch, out_ch)
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, emb, train: bool, generator=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_cemb_proj(F.silu(emb))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if train and self.dropout > 0.0:
            # flax nn.Dropout: keep with prob 1 − rate, scale by 1/keep
            keep = 1.0 - self.dropout
            mask = dist_ctx.rand(h.shape, generator=generator,
                                 device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        h = self.conv2(h)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over H·W tokens
    (diffusion.py:148-192)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = group_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(t):  # the JAX NHWC token order, contiguous for K2
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()

        out = scaled_dot_attention(tokens(self.q(y)), tokens(self.k(y)),
                                   tokens(self.v(y)), scale=c ** -0.5)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        if hasattr(self, "conv"):
            # asymmetric (0,1)x(0,1) pad + stride-2 valid conv
            # (diffusion.py:66-81)
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


def _embedding_mlp(ch: int) -> nn.Module:
    mlp = nn.Module()
    mlp.dense = nn.ModuleList([nn.Linear(ch, 4 * ch),
                               nn.Linear(4 * ch, 4 * ch)])
    return mlp


def _mlp(mlp: nn.Module, x):
    return mlp.dense[1](F.silu(mlp.dense[0](x)))


class ConditionalUNet(nn.Module):
    """CFG-conditional eps-prediction U-Net."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch, emb_ch = cfg.ch, 8 * cfg.ch
        self.temb = _embedding_mlp(ch)
        self.cemb = _embedding_mlp(ch)
        self.classes_emb = nn.Embedding(cfg.n_classes, ch)
        self.null_classes_emb = nn.Parameter(torch.zeros(ch))
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)

        num_res = len(cfg.ch_mult)
        res = cfg.image_size
        skips = [ch]  # channels of every tensor the up path concatenates
        block_in = ch
        self.down = nn.ModuleList()
        for i_level in range(num_res):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, emb_ch,
                                               cfg.dropout))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
                skips.append(block_in)
            if i_level != num_res - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv)
                res //= 2
                skips.append(block_in)
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, emb_ch,
                                       cfg.dropout)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, emb_ch,
                                       cfg.dropout)

        up = {}
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in + skips.pop(),
                                               block_out, emb_ch,
                                               cfg.dropout))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv)
                res *= 2
            up[i_level] = level
        self.up = nn.ModuleList([up[i] for i in range(num_res)])

        self.norm_out = group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, x, t, c, *, train: bool = False,
                cond_drop_prob: Optional[float] = None,
                keep_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x NCHW in [−1,1]; t float timesteps; c int class labels.

        The class embedding is dropped per sample with prob
        ``cond_drop_prob`` (drawn from ``generator``), or where the boolean
        ``keep_mask`` is False. With ``train`` and dropout > 0, dropout
        masks are drawn from ``generator`` after the cond-drop draw, block
        by block.
        """
        cfg = self.cfg
        p_drop = cfg.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
        n = x.shape[0]
        temb = _mlp(self.temb, timestep_embedding(t, cfg.ch))
        if keep_mask is None:
            if p_drop >= 1.0:
                keep_mask = torch.zeros(n, dtype=torch.bool, device=x.device)
            elif p_drop <= 0.0:
                keep_mask = torch.ones(n, dtype=torch.bool, device=x.device)
            else:
                keep_mask = dist_ctx.rand((n,), generator=generator,
                                          device=x.device) < 1.0 - p_drop
        cemb = torch.where(keep_mask[:, None], self.classes_emb(c.long()),
                           self.null_classes_emb[None, :])
        emb = torch.cat([temb, _mlp(self.cemb, cemb)], dim=-1)

        def block(mod, h):
            return mod(h, emb, train, generator)

        hs = [self.conv_in(x)]
        for level in self.down:
            for i, res_block in enumerate(level.block):
                h = block(res_block, hs[-1])
                if len(level.attn):
                    h = level.attn[i](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = block(self.mid.block_1, hs[-1])
        h = self.mid.attn_1(h)
        h = block(self.mid.block_2, h)

        for level in reversed(self.up):
            for i, res_block in enumerate(level.block):
                h = block(res_block, torch.cat([h, hs.pop()], dim=1))
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)

        return self.conv_out(F.silu(self.norm_out(h)))


def attention_sites(cfg: UNetConfig) -> int:
    """``AttnBlock`` calls per forward: one launch of K2 each."""
    n_res = sum(cfg.image_size // 2 ** i in cfg.attn_resolutions
                for i in range(len(cfg.ch_mult)))
    return n_res * (2 * cfg.num_res_blocks + 1) + 1


@torch.no_grad()
def init_unet(model: ConditionalUNet, seed: int) -> ConditionalUNet:
    """Seeded random weights, drawn on the CPU: lecun-normal conv and
    dense weights (std fan_in^-1/2, flax's default scale) with zero bias,
    GroupNorm 1/0, N(0, 1) class and null embeddings."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * fan_in ** -0.5)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
    model.null_classes_emb.copy_(
        torch.randn(model.null_classes_emb.shape, generator=gen))
    return model


def cfg_eps(model: ConditionalUNet, x, t, c, cond_scale: float):
    """Classifier-free-guided eps (1+s)·eps_c − s·eps_∅
    (diffusion.py:340-355), as ONE forward on the stacked 2B batch with an
    explicit ``keep_mask``."""
    if cond_scale == 0.0:
        return model(x, t, c, train=False, cond_drop_prob=0.0)
    b = x.shape[0]
    keep = torch.arange(2 * b, device=x.device) < b
    eps2 = model(torch.cat([x, x]), torch.cat([t, t]), torch.cat([c, c]),
                 train=False, keep_mask=keep)
    eps_c, eps_null = eps2[:b], eps2[b:]
    return (1.0 + cond_scale) * eps_c - cond_scale * eps_null
