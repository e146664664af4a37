"""Plain PyTorch building blocks of the reference models.

Softmax attention and GroupNorm → SiLU written out in their plain forms,
with no fused kernel, and the diffusion schedule tables. Imports nothing
but torch and numpy.

An observer (``observe``) sees every attention and GroupNorm → SiLU call
with its shapes; the benchmark's work counter reads the configuration's
attention and norm work through it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

_OBSERVERS: list = []


@contextlib.contextmanager
def observe(fn):
    """Call ``fn(kind, **shape)`` on every attention and norm call inside
    the block (``kind``: ``"attention"``, ``"text_attention"`` or
    ``"gn_silu"``)."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def _notify(kind, **shape):
    for fn in _OBSERVERS:
        fn(kind, **shape)


@contextlib.contextmanager
def fp32_exact():
    """Matrix products and convolutions in full fp32 (TF32 off) inside the
    block; the settings before it are restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def attention(q, k, v, scale: float, mask=None, kind: str = "attention"):
    """softmax(q·kᵀ·scale + mask)·v over ``[B, N, D]``."""
    _notify(kind, b=q.shape[0], nq=q.shape[1], nk=k.shape[1], d=q.shape[2],
            grad=torch.is_grad_enabled())
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def multi_head(q, k, v, heads: int, scale: float):
    """``[B, N, H·D]`` → heads folded into the batch → attention → back."""
    b, nq, hd = q.shape
    d, nk = hd // heads, k.shape[1]

    def fold(x, n):
        return x.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads,
                                                                 n, d)

    out = attention(fold(q, nq), fold(k, nk), fold(v, nk), scale)
    return out.reshape(b, heads, nq, d).transpose(1, 2).reshape(b, nq, hd)


class GroupNormSiLU(nn.GroupNorm):
    """GroupNorm, then SiLU, as two plain operations."""

    def forward(self, x):
        _notify("gn_silu", numel=x.numel(), grad=torch.is_grad_enabled())
        return torch.nn.functional.silu(super().forward(x))


def spatial_tokens(x):
    """NCHW → [B, H·W, C]."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).transpose(1, 2)


class Schedule:
    """β and ᾱ tables (computed in float64, held in float32)."""

    def __init__(self, kind: str, start: float, end: float, steps: int,
                 device):
        if kind == "quad":
            betas = np.linspace(start ** 0.5, end ** 0.5, steps) ** 2
        elif kind == "linear":
            betas = np.linspace(start, end, steps)
        else:
            raise ValueError(kind)
        self.num_timesteps = steps
        self.alphas_cumprod = torch.tensor(np.cumprod(1.0 - betas),
                                           dtype=torch.float32, device=device)

    def alpha_bar(self, t):
        """ᾱ_t at integer timesteps, with ᾱ_{-1} = 1."""
        acp = torch.cat([self.alphas_cumprod.new_ones(1), self.alphas_cumprod])
        return acp[t.long() + 1]

    def q_sample(self, x0, t, noise):
        a = self.alphas_cumprod[t.long()].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def global_norm_clip(grads, max_norm: float):
    """Scale every gradient by max_norm / ‖g‖ when the global norm is at or
    above ``max_norm``."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    if float(norm) < max_norm:
        return list(grads)
    return [g / norm * max_norm for g in grads]


def top_fraction_mask(abs_saliency, fraction: float):
    """0/1 masks keeping the ``int(N·fraction)`` largest values over all
    tensors, ties to the lower flat index."""
    flat = torch.cat([t.reshape(-1) for t in abs_saliency])
    k = int(flat.numel() * fraction)
    order = torch.sort(flat, descending=True, stable=True).indices
    keep = torch.zeros(flat.numel(), dtype=torch.bool, device=flat.device)
    keep[order[:k]] = True
    del order
    out, o = [], 0
    for t in abs_saliency:
        out.append(keep[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


class Adam:
    """Adam (β₁, β₂, ε as given), bias-corrected, no weight decay."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
