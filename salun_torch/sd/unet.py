"""Stable-Diffusion U-Net (CompVis ``UNetModel``), counterpart of
``salun/sd/unet.py``.

SD/ldm/modules/diffusionmodules/openaimodel.py:428-1064 for the sd-v1
configuration (4-channel latents, model_channels 320, channel_mult
[1,2,4,4], 2 res blocks, attention at ds ∈ {1,2,4}, 8 heads,
SpatialTransformer depth 1 over a 768-d CLIP context) with the ResBlock /
SpatialTransformer / CrossAttention / GEGLU blocks (openaimodel.py:177-290,
ldm/modules/attention.py:37-303). NCHW; module names are CompVis's
(``input_blocks.4.1.transformer_blocks.0.attn2.to_k``), so a CompVis state
dict loads as it is.

Kernels: each ResBlock's ``in_layers`` and ``out_layers`` GroupNorm → SiLU
and the final ``out`` pair run as K4 (:class:`GroupNormSiLU`, eps 1e-5),
with K4b in the backward; ``SpatialTransformer.norm`` (eps 1e-6, no SiLU)
stays ``nn.GroupNorm``. Every CrossAttention runs through
``multi_head_attention``: K2 forward, K3a/K3b backward.

``remat`` (the reference's ``use_checkpoint``) wraps each ResBlock and
SpatialTransformer in non-reentrant ``torch.utils.checkpoint``: their
activations are recomputed in the backward, K2 and K4 launched again.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from salun_torch.kernels.attention import multi_head_attention
from salun_torch.kernels.groupnorm_silu import GroupNormSiLU


def openai_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """OpenAI-UNet sinusoidal embedding: cos first, frequencies over
    ``half`` (ldm util.py timestep_embedding). NOT the DDPM variant (sin
    first, over ``half − 1``): the two disagree, and the wrong one silently
    breaks imported sd-v1 weights."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


@dataclass(frozen=True)
class SDUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dropout: float = 0.0
    remat: bool = False


class CrossAttention(nn.Module):
    """attention.py:149-194; ``context=None`` → self-attention."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        context = x if context is None else context
        out = multi_head_attention(self.to_q(x), self.to_k(context),
                                   self.to_v(context), self.heads,
                                   scale=self.scale)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU


class FeedForward(nn.Module):
    """GEGLU FF (attention.py:37-63): ``net.0.proj``, ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(),
                                 nn.Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """attention.py:246-303: GN → 1×1 in → blocks → 1×1 out (zero-init),
    plus the residual."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(inner, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context):
        b, _, h, w = x.shape
        y = self.proj_in(self.norm(x))
        inner = y.shape[1]
        y = y.reshape(b, inner, h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.transpose(1, 2).reshape(b, inner, h, w)
        return x + self.proj_out(y)


class ResBlock(nn.Module):
    """openaimodel.py:177-290 (no scale-shift in sd-v1; the out conv is
    zero-initialised)."""

    def __init__(self, in_ch: int, emb_ch: int, out_ch: int,
                 dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNormSiLU(32, in_ch, eps=1e-5), nn.Identity(),
            nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, out_ch))
        self.out_layers = nn.Sequential(
            GroupNormSiLU(32, out_ch, eps=1e-5), nn.Identity(),
            nn.Dropout(dropout), nn.Conv2d(out_ch, out_ch, 3, padding=1))
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = (nn.Identity() if in_ch == out_ch
                                else nn.Conv2d(in_ch, out_ch, 1))

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """Layers fed (x, emb, context) as each needs (openaimodel.py:70-84);
    with ``remat``, each ResBlock and SpatialTransformer is checkpointed."""

    remat = False

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                fn, args = layer, (x, emb)
            elif isinstance(layer, SpatialTransformer):
                fn, args = layer, (x, context)
            else:
                x = layer(x)
                continue
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(fn, *args, use_reentrant=False)
            else:
                x = fn(*args)
        return x


class SDUNet(nn.Module):
    """``forward(x, t, context)``: x NCHW latents, t float timesteps [B],
    context [B, L, context_dim] → eps, NCHW."""

    def __init__(self, cfg: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        mc = c.model_channels
        time_dim = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, time_dim), nn.SiLU(),
                                        nn.Linear(time_dim, time_dim))

        def res(cin, cout):
            return ResBlock(cin, time_dim, cout, c.dropout)

        def spatial(ch):
            return SpatialTransformer(ch, c.num_heads, ch // c.num_heads,
                                      c.transformer_depth, c.context_dim)

        blocks = [TimestepEmbedSequential(
            nn.Conv2d(c.in_channels, mc, 3, padding=1))]
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(c.channel_mult):
            for _ in range(c.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in c.attention_resolutions:
                    layers.append(spatial(ch))
                blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(c.channel_mult) - 1:
                blocks.append(TimestepEmbedSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = TimestepEmbedSequential(res(ch, ch), spatial(ch),
                                                    res(ch, ch))
        blocks = []
        for level, mult in reversed(list(enumerate(c.channel_mult))):
            for j in range(c.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in c.attention_resolutions:
                    layers.append(spatial(ch))
                if level and j == c.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                blocks.append(TimestepEmbedSequential(*layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(GroupNormSiLU(32, ch, eps=1e-5),
                                 nn.Identity(),
                                 nn.Conv2d(ch, c.out_channels, 3, padding=1))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)
        for m in self.modules():
            if isinstance(m, TimestepEmbedSequential):
                m.remat = c.remat

    def forward(self, x, t, context):
        emb = self.time_embed(openai_timestep_embedding(
            t, self.cfg.model_channels))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)


def kernel_sites(cfg: SDUNetConfig) -> dict:
    """Launches per U-Net forward at ``cfg``: K2 (two attentions per
    transformer block) and K4 (two per ResBlock and ``out``); with
    ``remat``, a forward with a gradient launches the checkpointed ones
    again in its backward (``k2_remat``, ``k4_remat``)."""
    n_levels = len(cfg.channel_mult)
    n_res = 2 + n_levels * (2 * cfg.num_res_blocks + 1)
    ds, n_attn = 1, 1  # the middle block's
    for level in range(n_levels):
        if ds in cfg.attention_resolutions:
            n_attn += 2 * cfg.num_res_blocks + 1
        ds *= 2
    k2 = 2 * cfg.transformer_depth * n_attn
    return {"k2": k2, "k4": 2 * n_res + 1,
            "k2_remat": k2 if cfg.remat else 0,
            "k4_remat": 2 * n_res if cfg.remat else 0}
