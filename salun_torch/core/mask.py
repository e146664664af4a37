"""Weight-saliency masks: the core of SalUn.

Counterpart of ``salun/core/mask.py``, ``salun/dist/topk.py`` and the
helpers of ``salun/utils/tree.py`` it needs. Algorithm
(reference Classification/generate_mask.py:30-82):

1. sum the gradients of the forgetting loss over the forget set, batch by
   batch, in fp32;
2. take |·|;
3. for each threshold t keep the top ``int(N * t)`` coordinates across all
   tensors, ties broken by ascending flat index in the concatenation of the
   tensors in the given order (``topk.py:92-138``).

The JAX package finds the k-th value by bisection so it can shard; on one
card one stable sort of all |g| values gives every coordinate its rank, and
each threshold is then one comparison. The order of the tensors (and their
layout) decides the ties: JAX flattens dict keys sorted, in HWIO; the port
defaults to ``named_parameters()`` order in OIHW, the original PyTorch
reference's order.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

from salun_torch.dist import context as dist_ctx

# The reference sweep (generate_mask.py:50).
DEFAULT_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def accumulate_saliency(loss_fn: Callable, params: Sequence[torch.Tensor],
                        batches: Iterable) -> list:
    """fp32 sum over ``batches`` of the gradient of ``loss_fn(batch)`` with
    respect to ``params``, then |·|. Returns one tensor per parameter.

    Under a ``--dp`` mesh each rank's ``batches`` are its shards (its rows
    over the global denominators): the partial sums are summed over the
    ranks once, before |·|, so every rank holds the same saliency."""
    params = list(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params]
    for batch in batches:
        grads = torch.autograd.grad(loss_fn(batch), params)
        for a, g in zip(acc, grads):
            a.add_(g.to(torch.float32))
    dist_ctx.all_reduce_(acc)
    return [a.abs_() for a in acc]


def saliency_ranks(abs_saliency: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rank of every coordinate of the concatenation (0 = largest), ties
    in ascending flat order: one stable descending sort."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in abs_saliency])
    order = torch.sort(flat, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=order.device)
    return ranks


def _split_like(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    sizes = [t.numel() for t in like]
    return [part.reshape(t.shape)
            for part, t in zip(torch.split(flat, sizes), like)]


def global_topk_masks(abs_saliency: Sequence[torch.Tensor], k: int,
                      ranks: torch.Tensor | None = None) -> list:
    """Exact top-k fp32 0/1 masks over a list of |saliency| tensors: every
    value above the k-th largest, then ties in ascending flat order."""
    if ranks is None:
        ranks = saliency_ranks(abs_saliency)
    return _split_like((ranks < int(k)).to(torch.float32), abs_saliency)


def threshold_mask(abs_saliency: Sequence[torch.Tensor], threshold: float,
                   ranks: torch.Tensor | None = None) -> list:
    """Mask keeping the top ``int(N * threshold)`` coordinates."""
    n = sum(t.numel() for t in abs_saliency)
    return global_topk_masks(abs_saliency, int(n * threshold), ranks)


def generate_masks(abs_saliency: Sequence[torch.Tensor],
                   thresholds: Sequence[float] = DEFAULT_THRESHOLDS) -> dict:
    """``{threshold: [mask per tensor]}`` from one sort."""
    ranks = saliency_ranks(abs_saliency)
    return {t: threshold_mask(abs_saliency, t, ranks) for t in thresholds}
