"""CLIP text encoder (ViT-L/14 text tower), counterpart of
``salun/sd/clip_text.py``.

``FrozenCLIPEmbedder`` (SD/ldm/modules/encoders/modules.py:230-266): HF
``CLIPTextModel`` last_hidden_state over 77 BPE tokens — vocab 49408,
width 768, 12 layers, 12 heads, quickGELU, causal mask, final LayerNorm
(eps 1e-5 throughout). Module names are HF's (``text_model.encoder.layers.0
.self_attn.q_proj``), so the CompVis checkpoint's
``cond_stage_model.transformer.*`` keys load as they are.

The attention is plain ``torch.matmul`` and softmax (an einsum outside any
Pallas kernel in JAX), with JAX's additive −1e9 causal mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, 4 * hidden)
        self.fc2 = nn.Linear(4 * hidden, hidden)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quickGELU


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, mask):
        b, n, d = x.shape
        hd = d // self.num_heads

        def split(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        logits = torch.matmul(split(self.q_proj(x)),
                              split(self.k_proj(x)).transpose(-1, -2))
        w = torch.softmax(logits * hd ** -0.5 + mask, dim=-1)
        o = torch.matmul(w, split(self.v_proj(x)))
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = CLIPMLP(d)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg)
                                    for _ in range(cfg.num_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids):
        n = input_ids.shape[1]
        emb = self.embeddings
        x = (emb.token_embedding(input_ids)
             + emb.position_embedding.weight[:n].unsqueeze(0))
        mask = torch.triu(torch.full((n, n), -1e9, dtype=x.dtype,
                                     device=x.device), diagonal=1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """``input_ids`` [B, L] int64 → last hidden state [B, L, width]."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids):
        return self.text_model(input_ids.long())


# ------------------------------------------------------------- tokenizer

_TOKENIZER = None


def get_tokenizer():
    """The real CLIP tokenizer (``salun_torch.sd.tokenizer`` assets).
    Raises FileNotFoundError when no assets are available."""
    global _TOKENIZER
    if _TOKENIZER is None:
        from .tokenizer import load_clip_tokenizer

        _TOKENIZER = load_clip_tokenizer()
    return _TOKENIZER


def tokenize(texts, max_length: int = 77) -> np.ndarray:
    """texts → int32 [B, max_length] CLIP BPE ids (BOS/EOS, EOS-padded),
    FrozenCLIPEmbedder's padding="max_length" call (modules.py:234-238).
    No approximate fallback."""
    return np.asarray(get_tokenizer()(list(texts), max_length), np.int32)
