"""Plain reference of the class-conditional CIFAR-10 DDPM of SalUn's DDPM
workload (Unlearn-Saliency DDPM/models/diffusion.py ``Conditional_Model``;
DDPM/runners/diffusion.py for the saliency loss and the random-label
step).

Parameter names follow the reference's module tree (``temb.dense.0``,
``down.1.attn.0.q``, ``classes_emb``, ``null_classes_emb``), so one state
dict fits this and the system under test alike. Attention is
softmax(q·kᵀ)·v (``ops``). Random draws inside a forward (the per-row
class drop, then one dropout mask a ResNet block, in the order the blocks
run) come from the ``torch.Generator`` handed in, in that order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import ops


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def norm(c):
    return nn.GroupNorm(32, c, eps=1e-6)


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm1 = norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_cemb_proj = nn.Linear(emb, cout)
        self.norm2 = norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, emb, gen):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_cemb_proj(F.silu(emb))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if gen is not None and self.dropout > 0:
            keep = 1.0 - self.dropout
            drop = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(drop, h / keep, torch.zeros_like(h))
        h = self.conv2(h)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class Attn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = norm(c)
        self.q, self.k, self.v = (nn.Conv2d(c, c, 1) for _ in range(3))
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        o = ops.attention(ops.spatial_tokens(self.q(y)),
                          ops.spatial_tokens(self.k(y)),
                          ops.spatial_tokens(self.v(y)), c ** -0.5)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, h, w))


def _mlp(ch):
    m = nn.Module()
    m.dense = nn.ModuleList([nn.Linear(ch, 4 * ch), nn.Linear(4 * ch, 4 * ch)])
    return m


class ConditionalUNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults = cfg["ch"], cfg["ch_mult"]
        nres, attn_at, drop = (cfg["num_res_blocks"], cfg["attn_resolutions"],
                               cfg["dropout"])
        self.cfg = cfg
        emb = 8 * ch
        self.temb, self.cemb = _mlp(ch), _mlp(ch)
        self.classes_emb = nn.Embedding(cfg["n_classes"], ch)
        self.null_classes_emb = nn.Parameter(torch.zeros(ch))
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch, 3, padding=1)
        res, skips, cin = cfg["image_size"], [ch], ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(mults):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(nres):
                level.block.append(Resnet(cin, ch * mult, emb, drop))
                cin = ch * mult
                if res in attn_at:
                    level.attn.append(Attn(cin))
                skips.append(cin)
            if i != len(mults) - 1:
                level.downsample = nn.Module()
                level.downsample.conv = nn.Conv2d(cin, cin, 3, stride=2)
                res //= 2
                skips.append(cin)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = Resnet(cin, cin, emb, drop)
        self.mid.attn_1 = Attn(cin)
        self.mid.block_2 = Resnet(cin, cin, emb, drop)
        up = {}
        for i in reversed(range(len(mults))):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(nres + 1):
                level.block.append(Resnet(cin + skips.pop(), ch * mults[i],
                                          emb, drop))
                cin = ch * mults[i]
                if res in attn_at:
                    level.attn.append(Attn(cin))
            if i != 0:
                level.upsample = nn.Module()
                level.upsample.conv = nn.Conv2d(cin, cin, 3, padding=1)
                res *= 2
            up[i] = level
        self.up = nn.ModuleList([up[i] for i in range(len(mults))])
        self.norm_out = norm(cin)
        self.conv_out = nn.Conv2d(cin, cfg["out_ch"], 3, padding=1)

    def forward(self, x, t, c, keep=None, gen=None, p_drop=0.0):
        """eps. ``keep`` ([B] bool) selects the class embedding per row;
        without it, rows keep theirs with probability 1 − ``p_drop``,
        drawn from ``gen``. With ``gen``, dropout is on."""
        ch = self.cfg["ch"]
        temb = self.temb.dense[1](F.silu(self.temb.dense[0](
            timestep_embedding(t, ch))))
        if keep is None:
            keep = torch.rand((x.shape[0],), generator=gen,
                              device=x.device) < 1.0 - p_drop
        cemb = torch.where(keep[:, None], self.classes_emb(c.long()),
                           self.null_classes_emb[None, :])
        cemb = self.cemb.dense[1](F.silu(self.cemb.dense[0](cemb)))
        emb = torch.cat([temb, cemb], dim=-1)
        hs = [self.conv_in(x)]
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(hs[-1], emb, gen)
                if len(level.attn):
                    h = level.attn[i](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample.conv(F.pad(hs[-1], (0, 1, 0, 1))))
        h = self.mid.block_1(hs[-1], emb, gen)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, emb, gen)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), emb, gen)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                      mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


def images01(batch_u8_nhwc, device):
    """uint8 NHWC → float NCHW in [0, 1]."""
    x = torch.as_tensor(batch_u8_nhwc).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def flip(x, flips):
    return torch.where(flips[:, None, None, None], x.flip(-1), x)


def saliency_loss(model, sched, x01, labels, draws, guidance: float):
    """DDPM mask generation's loss for one batch: the eps-MSE (summed over
    pixels, meaned over rows) of the CFG prediction (1+s)·e_c − s·e_∅."""
    x = flip(x01, draws["flips"]) * 2.0 - 1.0
    t, e = draws["t"], draws["e"]
    xt = sched.q_sample(x, t, e)
    b = xt.shape[0]
    keep = torch.arange(2 * b, device=x.device) < b
    e2 = model(torch.cat([xt, xt]), torch.cat([t, t]).float(),
               torch.cat([labels, labels]), keep=keep)
    eps = (1 + guidance) * e2[:b] - guidance * e2[b:]
    return (e - eps).square().sum(dim=(1, 2, 3)).mean()


def random_label_loss(model, sched, remain, forget, draws, gen, cfg: dict):
    """The rl loss of the saliency_unlearn step: α·eps-MSE on the remain
    rows plus mean((pseudo − out)²) on the forget rows, where ``pseudo``
    predicts the forget rows as class (forget + 1) under the same class
    drop and dropout draws as ``out``, without gradient."""
    p_drop = cfg["cond_drop_prob"]
    xr = flip(remain["x01"], draws["remain"]["flips"]) * 2.0 - 1.0
    tr, er = draws["remain"]["t"], draws["remain"]["e"]
    out_r = model(sched.q_sample(xr, tr, er), tr.float(), remain["labels"],
                  gen=gen, p_drop=p_drop)
    remain_loss = (er - out_r).square().sum(dim=(1, 2, 3)).mean()
    xf = flip(forget["x01"], draws["forget"]["flips"]) * 2.0 - 1.0
    tf, ef = draws["forget"]["t"], draws["forget"]["e"]
    xt = sched.q_sample(xf, tf, ef)
    state = gen.get_state()
    out = model(xt, tf.float(), forget["labels"], gen=gen, p_drop=p_drop)
    gen.set_state(state)
    pseudo_c = torch.full_like(forget["labels"],
                               (cfg["label_to_forget"] + 1) % cfg["n_classes"])
    with torch.no_grad():
        pseudo = model(xt, tf.float(), pseudo_c, gen=gen, p_drop=p_drop)
    return (pseudo - out).square().mean() + cfg["alpha"] * remain_loss
