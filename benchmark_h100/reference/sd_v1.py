"""Plain reference of Stable Diffusion v1 as SalUn's SD workload runs it.

The CompVis ``UNetModel`` (sd-v1: 4-channel latents, 320 channels,
channel_mult [1, 2, 4, 4], 2 res blocks, attention at ds 1, 2, 4, 8
heads, a 768-d context), the AutoencoderKL (ch 128, ch_mult [1, 2, 4, 4],
mid-block attention), the CLIP ViT-L/14 text tower and CLIP's byte-level
BPE, after ldm/modules/diffusionmodules/openaimodel.py, ldm/modules/
attention.py, ldm/modules/diffusionmodules/model.py and HF's CLIPTextModel.
Parameter names are CompVis's and HF's, so one state dict fits this and
the system under test alike.

Attention is softmax(q·kᵀ)·v and GroupNorm → SiLU two plain operations
(``ops``). No activation checkpointing: the reference recomputes nothing.
The SalUn pieces follow SD/train-scripts: the saliency loss of
generate_mask.py and the random-label loss of random_label.py, and the
DDIM sampler with classifier-free guidance of generate-images.py.
"""

from __future__ import annotations

import html
import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

# ----------------------------------------------------------------- U-Net


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = dim if context_dim is None else context_dim
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x, context=None):
        context = x if context is None else context
        out = ops.multi_head(self.to_q(x), self.to_k(context),
                             self.to_v(context), self.heads, self.scale)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Identity(),
                                 nn.Linear(4 * dim, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, context_dim: int, depth: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, heads, ch // heads, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = ops.spatial_tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


class ResBlock(nn.Module):
    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(ops.GroupNormSiLU(32, cin, eps=1e-5),
                                       nn.Identity(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, cout))
        self.out_layers = nn.Sequential(ops.GroupNormSiLU(32, cout, eps=1e-5),
                                        nn.Identity(), nn.Identity(),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = (nn.Identity() if cin == cout
                                else nn.Conv2d(cin, cout, 1))

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
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


class Step(nn.Sequential):
    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNet(nn.Module):
    """eps(x NCHW, t [B], context [B, L, 768])."""

    def __init__(self, cfg: dict):
        super().__init__()
        mc = cfg["model_channels"]
        mults, nres = cfg["channel_mult"], cfg["num_res_blocks"]
        attn_at, heads = cfg["attention_resolutions"], cfg["num_heads"]
        cdim, depth = cfg["context_dim"], cfg["transformer_depth"]
        self.mc = mc
        temb = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, temb), nn.SiLU(),
                                        nn.Linear(temb, temb))
        blocks = [Step(nn.Conv2d(cfg["in_channels"], mc, 3, padding=1))]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(mults):
            for _ in range(nres):
                layers = [ResBlock(ch, temb, mult * mc)]
                ch = mult * mc
                if ds in attn_at:
                    layers.append(SpatialTransformer(ch, heads, cdim, depth))
                blocks.append(Step(*layers))
                chans.append(ch)
            if level != len(mults) - 1:
                blocks.append(Step(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = Step(ResBlock(ch, temb, ch),
                                 SpatialTransformer(ch, heads, cdim, depth),
                                 ResBlock(ch, temb, ch))
        blocks = []
        for level, mult in reversed(list(enumerate(mults))):
            for j in range(nres + 1):
                layers = [ResBlock(ch + chans.pop(), temb, mult * mc)]
                ch = mult * mc
                if ds in attn_at:
                    layers.append(SpatialTransformer(ch, heads, cdim, depth))
                if level and j == nres:
                    layers.append(Upsample(ch))
                    ds //= 2
                blocks.append(Step(*layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(ops.GroupNormSiLU(32, ch, eps=1e-5),
                                 nn.Identity(),
                                 nn.Conv2d(ch, cfg["out_channels"], 3,
                                           padding=1))

    def forward(self, x, t, context):
        emb = self.time_embed(timestep_embedding(t, self.mc))
        hs, h = [], x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)


# ------------------------------------------------------------------ VAE


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = ops.GroupNormSiLU(32, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = ops.GroupNormSiLU(32, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, eps=1e-6)
        self.q, self.k, self.v = (nn.Conv2d(c, c, 1) for _ in range(3))
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        o = ops.attention(ops.spatial_tokens(self.q(y)),
                          ops.spatial_tokens(self.k(y)),
                          ops.spatial_tokens(self.v(y)), c ** -0.5)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, h, w))


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = VAEResnet(c, c)
        self.attn_1 = VAEAttn(c)
        self.block_2 = VAEResnet(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Level(nn.Module):
    def __init__(self, blocks, resample=None, name=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class VAEDown(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch, 3, padding=1)
        levels, cin = [], ch
        for i, mult in enumerate(mults):
            blocks = []
            for _ in range(nres):
                blocks.append(VAEResnet(cin, ch * mult))
                cin = ch * mult
            last = i == len(mults) - 1
            levels.append(Level(blocks, None if last else VAEDown(cin),
                                "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = Mid(cin)
        self.norm_out = ops.GroupNormSiLU(32, cin, eps=1e-6)
        self.conv_out = nn.Conv2d(cin, 2 * cfg["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        cin = ch * mults[-1]
        self.conv_in = nn.Conv2d(cfg["z_channels"], cin, 3, padding=1)
        self.mid = Mid(cin)
        levels = [None] * len(mults)
        for i in reversed(range(len(mults))):
            blocks = []
            for _ in range(nres + 1):
                blocks.append(VAEResnet(cin, ch * mults[i]))
                cin = ch * mults[i]
            levels[i] = Level(blocks, Upsample(cin) if i else None,
                              "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = ops.GroupNormSiLU(32, cin, eps=1e-6)
        self.conv_out = nn.Conv2d(cin, cfg["out_ch"], 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h))


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        z, e = cfg["z_channels"], cfg["embed_dim"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * e, 1)
        self.post_quant_conv = nn.Conv2d(e, z, 1)

    def moments(self, x):
        mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ----------------------------------------------------------------- CLIP


class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(d, d) for _ in range(4))

    def forward(self, x, mask):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2).reshape(
                b * self.heads, n, hd)

        o = ops.attention(split(self.q_proj(x)), split(self.k_proj(x)),
                          split(self.v_proj(x)), hd ** -0.5, mask,
                          kind="text_attention")
        o = o.reshape(b, self.heads, n, hd).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(o)


class CLIPMLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(d)
        self.self_attn = CLIPAttention(d, heads)
        self.layer_norm2 = nn.LayerNorm(d)
        self.mlp = CLIPMLP(d)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPText(nn.Module):
    """ids [B, L] → last hidden state [B, L, d]; module names HF's under
    ``text_model``."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_length"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            CLIPLayer(d, cfg["num_heads"]) for _ in range(cfg["num_layers"]))
        tm.final_layer_norm = nn.LayerNorm(d)
        self.text_model = tm

    def forward(self, ids):
        tm = self.text_model
        n = ids.shape[1]
        x = (tm.embeddings.token_embedding(ids.long())
             + tm.embeddings.position_embedding.weight[:n][None])
        causal = torch.full((n, n), float("-inf"), device=x.device)
        mask = torch.triu(causal, diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# ------------------------------------------------------------ tokenizer


def _byte_symbols():
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


_PATTERN = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m"
                      r"|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE)


class Tokenizer:
    """CLIP's byte-level BPE over an OpenAI merges file: the vocabulary is
    the 256 byte symbols, the same with ``</w>``, the merges, then the
    start and end tokens; ids padded to ``length`` with the end token."""

    def __init__(self, merges_path: str):
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        self.merges = {tuple(m.split()): i
                       for i, m in enumerate(x for x in lines if x)}
        table = _byte_symbols()
        self.byte = table
        # the byte symbols in the OpenAI order: the printable ones first
        printable = [b for b in range(256) if table[b] == chr(b)]
        rest = [b for b in range(256) if table[b] != chr(b)]
        symbols = [table[b] for b in printable + rest]
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(m) for m in sorted(self.merges,
                                             key=self.merges.get)]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {t: i for i, t in enumerate(vocab)}
        self.bos, self.eos = len(vocab) - 2, len(vocab) - 1

    def _bpe(self, word):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.merges.get(p, math.inf), i) for i, p in
                      enumerate(zip(parts, parts[1:]))]
            best, at = min(ranked)
            if best == math.inf:
                break
            first, second = parts[at], parts[at + 1]
            out, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == first
                        and parts[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        return parts

    def __call__(self, texts, length: int = 77):
        out = torch.full((len(texts), length), self.eos, dtype=torch.long)
        out[:, 0] = self.bos
        for row, text in enumerate(texts):
            text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)))
            ids = []
            for tok in _PATTERN.findall(text.strip().lower()):
                word = "".join(self.byte[b] for b in tok.encode("utf-8"))
                ids += [self.ids[p] for p in self._bpe(word)]
            ids = ids[:length - 2]
            out[row, 1:1 + len(ids)] = torch.tensor(ids, dtype=torch.long)
        return out


# ------------------------------------------------------------- the model


class StableDiffusion(nn.Module):
    """The three models; ``unet.*``, ``vae.*`` and ``clip.*`` are the
    system under test's ``SDModules`` fields of the same names."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.unet = UNet(cfg["unet"])
        self.vae = VAE(cfg["vae"])
        self.clip = CLIPText(cfg["clip"])
        s = cfg["schedule"]
        self.scale_factor = cfg["vae"]["scale_factor"]
        self.schedule_args = (s["kind"], s["linear_start"], s["linear_end"],
                              s["timesteps"])

    def schedule(self, device):
        return ops.Schedule(*self.schedule_args, device=device)

    def latent(self, images, posterior_noise):
        mean, logvar = self.vae.moments(images)
        return (mean + torch.exp(0.5 * logvar) * posterior_noise) * \
            self.scale_factor


def saliency_loss(sd: StableDiffusion, sched, images, ids_c, ids_u, draws,
                  guidance: float):
    """generate_mask.py's loss for one batch: −MSE(noise, (1+g)·e_c − g·e_∅)
    at q_sample(z₀, t, noise)."""
    with torch.no_grad():
        z0 = sd.latent(images, draws["posterior"])
        ctx = torch.cat([sd.clip(ids_c), sd.clip(ids_u)])
    t = draws["t"]
    z_t = sched.q_sample(z0, t, draws["noise"])
    e2 = sd.unet(torch.cat([z_t, z_t]), torch.cat([t, t]).float(), ctx)
    b = z0.shape[0]
    eps = (1 + guidance) * e2[:b] - guidance * e2[b:]
    return -(draws["noise"] - eps).square().mean()


def random_label_parts(sd: StableDiffusion, sched, batch, draws,
                       alpha: float):
    """random_label.py's loss in its two parts, each a function to call
    and differentiate apart: forget MSE(out, pseudo) and α·remain eps-MSE.
    The forget and pseudo forwards see two posterior draws of the same
    images and share t and noise."""

    def remain():
        with torch.no_grad():
            z0 = sd.latent(batch["remain_images"], draws["remain_posterior"])
            ctx = sd.clip(batch["remain_ids"])
        t = draws["remain_t"]
        out = sd.unet(sched.q_sample(z0, t, draws["remain_noise"]), t.float(),
                      ctx)
        return alpha * (draws["remain_noise"] - out).square().mean()

    def forget():
        t, noise = draws["forget_t"], draws["forget_noise"]
        with torch.no_grad():
            z_f = sd.latent(batch["forget_images"], draws["forget_posterior"])
            z_p = sd.latent(batch["forget_images"], draws["pseudo_posterior"])
            ctx_f = sd.clip(batch["forget_ids"])
            ctx_p = sd.clip(batch["pseudo_ids"])
            pseudo = sd.unet(sched.q_sample(z_p, t, noise), t.float(), ctx_p)
        out = sd.unet(sched.q_sample(z_f, t, noise), t.float(), ctx_f)
        return (out - pseudo).square().mean()

    return forget, remain


@torch.no_grad()
def ddim_sample(sd: StableDiffusion, sched, ids_c, ids_u, z, steps: int,
                guidance: float):
    """DDIM (η = 0) with classifier-free guidance over the ldm grid
    range(0, T, T // steps) + 1 without its last point, ᾱ₀ at the end;
    then the VAE decode, mapped to [0, 1]."""
    T = sched.num_timesteps
    grid = [s + 1 for s in range(0, T, T // steps)][:-1]
    ctx = torch.cat([sd.clip(ids_c), sd.clip(ids_u)])
    n = z.shape[0]
    nxt = [-1] + grid[:-1]
    final = sched.alphas_cumprod[0]
    for t, t_next in zip(reversed(grid), reversed(nxt)):
        tt = torch.full((n,), t, device=z.device)
        a = sched.alpha_bar(tt).reshape(-1, 1, 1, 1)
        a_next = (sched.alpha_bar(torch.full_like(tt, t_next)).reshape(
            -1, 1, 1, 1) if t_next >= 0 else final.expand_as(a))
        e2 = sd.unet(torch.cat([z, z]), torch.cat([tt, tt]).float(), ctx)
        e = e2[n:] + guidance * (e2[:n] - e2[n:])
        x0 = (z - e * torch.sqrt(1 - a)) / torch.sqrt(a)
        z = torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * e
    img = sd.vae.decode(z / sd.scale_factor)
    return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
