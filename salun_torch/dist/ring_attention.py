"""Sequence-parallel (ring) attention over a mesh axis (counterpart of
``salun/dist/ring_attention.py``).

Exact non-causal attention with q, k and v split along the sequence over
the ``p`` ranks of a mesh axis (Liu et al., arXiv:2310.01889): each rank
keeps its q block and, for ``p`` steps, folds in the k/v block it holds
with the online-softmax update (running max ``m``, sum ``l`` and fp32
accumulator ``acc``, as the flash kernels keep them), then passes k/v to
the next rank round the ring (``collectives.ring_shift``, whose backward
is the reverse ring). No rank holds more than ``(N/p)²`` logits a head.

The fold is plain torch, step for step as JAX writes it, and its backward
recomputes the step's logits (``torch.utils.checkpoint``, JAX's
``jax.checkpoint(step)``); the shift stays outside the checkpointed
region, so the recompute sends nothing. The port's flash kernel K2 is not
used here: merging its blocks through its log-sum-exp would need that
lse's gradient, which K3a/K3b do not take.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .collectives import axis_group, require_same, ring_shift


def _fold(q, kv, m, l, acc, scale: float):
    """One ring step: this rank's q block against the k/v block ``kv``
    ([B, n, 2C], k then v) it holds."""
    k, v = kv.chunk(2, dim=-1)
    s = torch.einsum("bqc,bkc->bqk", q, k).to(torch.float32) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    w = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + w.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bqk,bkc->bqc", w, v.to(torch.float32))
    return m_new, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, seq_axis: str = "data",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over ``mesh``'s
    ``seq_axis``.

    Every rank of the axis calls it with its own blocks: ``q`` [B, nq, C]
    and ``k``, ``v`` [B, nk, C], block ``i`` of the sequences on the rank
    at place ``i`` along the axis; each gets back its rows of the output,
    [B, nq, C] in ``q``'s dtype. Blocks of unequal length on the ranks (a
    sequence the axis does not divide) raise ``ValueError`` on every rank,
    after one small exchange of the lengths and before any data moves.
    Without a mesh (or along an axis of one rank) it is attention over the
    blocks given, the one-process form. ``scale`` defaults to C^-1/2.
    Gradients reach q, k and v of every rank (each rank calls
    ``backward``; the reverse ring runs in it)."""
    axis = axis_group(mesh, seq_axis)
    require_same((q.shape[1], k.shape[1]), axis, q.device,
                 f"sequence blocks differ in length over {seq_axis} axis "
                 f"size {axis.size}: the sequence is not divisible by it")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, nq, C = q.shape
    m = torch.full((B, nq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    kv = torch.cat([k, v], dim=-1)  # one shift a step carries both
    for step in range(axis.size):
        m, l, acc = checkpoint(_fold, q, kv, m, l, acc, scale,
                               use_reentrant=False)
        if step < axis.size - 1:  # the last block needs no onward trip
            kv = ring_shift(kv, axis)
    return (acc / l[..., None]).to(q.dtype)
