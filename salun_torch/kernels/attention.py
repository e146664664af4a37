"""Attention entry points (counterpart of ``salun/kernels/attention.py``).

``scaled_dot_attention`` is the attention of every port model (the DDPM
``AttnBlock`` first). The dispatch rule is the port's own, not the TPU's
(``salun`` sends sequences below 1024 to XLA): a CUDA tensor always goes
through the flash kernels, K2 forward and K3a/K3b backward, at every
sequence length, and raises for a shape they do not take; a CPU tensor
takes their plain PyTorch versions. There is no fallback and no switch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import FlashAttention, flash_attention_fwd


def scaled_dot_attention(q, k, v, *, scale: Optional[float] = None):
    """Single-head softmax(q·kᵀ·scale)·v over contiguous fp32 ``[B, N, D]``
    tensors; ``scale`` defaults to D^-1/2. With a gradient to compute it is
    the autograd function (K2 with lse, then K3a/K3b); otherwise K2 alone,
    without lse."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


def multi_head_attention(q, k, v, num_heads: int, *, scale=None):
    """``[B, N, H·D]`` → heads folded into the batch → single-head
    attention → unfolded, as ``salun``'s ``multi_head_attention``."""
    b, nq, hd = q.shape
    d = hd // num_heads
    nk = k.shape[1]

    def fold(x, n):
        return (x.reshape(b, n, num_heads, d).transpose(1, 2)
                 .reshape(b * num_heads, n, d).contiguous())

    out = scaled_dot_attention(
        fold(q, nq), fold(k, nk), fold(v, nk),
        scale=scale if scale is not None else d ** -0.5)
    return out.reshape(b, num_heads, nq, d).transpose(1, 2).reshape(b, nq, hd)
