"""Pruning over a model's parameters (counterpart of
``salun/core/pruner.py``; reference Classification/pruner/utils.py:23-325).

Global unstructured L1 or random pruning of every conv kernel, mask
application, extraction and reversal, sparsity checks, and the SNIP,
GraSP and SynFlow importance scores.

Parameters, scores and masks are dicts ``{torch name: tensor}`` in
``named_parameters`` order. A prune mask covers every parameter: fp32
0/1 on conv kernels (4-D, OIHW), all ones elsewhere; only conv weights
are pruned, as the reference prunes ``nn.Conv2d`` weights only.

Ties: the selection is the port's exact global top-k
(:func:`salun_torch.core.mask.global_topk_masks`), which breaks exact ties
in ascending flat order of the concatenated conv kernels in OIHW. The JAX
package concatenates its HWIO kernels in sorted-key order, so where two
scores are exactly equal at the threshold the two masks may keep
different coordinates; anywhere else they agree.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from salun_torch.core.mask import global_topk_masks

Tensors = Dict[str, torch.Tensor]


def is_conv_kernel(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() == 4


def ones_mask(params: Tensors) -> Tensors:
    return {n: torch.ones_like(p, dtype=torch.float32)
            for n, p in params.items()}


def apply_prune_mask(params: Tensors, mask: Optional[Tensors]) -> Tensors:
    """Effective (pruned) parameters ``p·m``."""
    if mask is None:
        return params
    return {n: p * mask[n].to(p.dtype) for n, p in params.items()}


def _prune_conv_by_scores(params: Tensors, scores_fn: Callable, px: float,
                          mask: Optional[Tensors] = None,
                          n_remaining: Optional[int] = None) -> Tensors:
    """Prune the globally lowest-scored ``px`` fraction of the REMAINING
    conv weights (``salun/core/pruner.py:39-75``): pruned weights score
    −∞ and stay pruned, and the prune count is ``round(px · n_remaining)``
    with Python's round-half-even, as torch's repeated
    ``prune.global_unstructured`` does."""
    conv = [n for n, p in params.items() if is_conv_kernel(p)]
    scores = []
    for n in conv:
        s = scores_fn(n, params[n]).to(torch.float32)
        if mask is not None:
            s = torch.where(mask[n] > 0, s, -torch.inf)
        scores.append(s)
    if n_remaining is not None:
        n_rem = int(n_remaining)
    elif mask is None:
        n_rem = sum(params[n].numel() for n in conv)
    else:
        n_rem = int(sum((mask[n] > 0).sum() for n in conv))
    keep = n_rem - round(px * n_rem)
    out = ones_mask(params)
    out.update(zip(conv, global_topk_masks(scores, keep)))
    return out


@torch.no_grad()
def global_l1_prune(params: Tensors, px: float,
                    mask: Optional[Tensors] = None) -> Tensors:
    """Prune the ``px`` fraction of the remaining conv weights with the
    smallest ``|w·m|`` (pruner/utils.py:23-35 pruning_model)."""
    eff = apply_prune_mask(params, mask)
    return _prune_conv_by_scores(params, lambda n, p: eff[n].abs(), px,
                                 mask)


@torch.no_grad()
def global_random_prune(params: Tensors, px: float,
                        mask: Optional[Tensors] = None, *,
                        uniform: Tensors) -> Tensors:
    """Random global pruning (pruner/utils.py:67-79): ``uniform`` holds a
    U[0, 1) score for each conv kernel (drawn by the caller, so that a
    test can hand in the JAX package's draws)."""
    return _prune_conv_by_scores(params, lambda n, p: uniform[n], px, mask)


def check_sparsity(params: Tensors, mask: Optional[Tensors]) -> float:
    """Remaining-weight % over conv kernels (utils.py check_sparsity)."""
    if mask is None:
        return 100.0
    kept = total = 0.0
    for n, p in params.items():
        if is_conv_kernel(p):
            kept += float(mask[n].sum())
            total += p.numel()
    return 100.0 * kept / max(total, 1.0)


def extract_mask(mask: Tensors) -> Tensors:
    """The conv entries of a mask (pruner extract_mask of ``*_mask``)."""
    return {n: m for n, m in mask.items() if is_conv_kernel(m)}


def reverse_mask(mask: Tensors) -> Tensors:
    return {n: 1.0 - m if is_conv_kernel(m) else m for n, m in mask.items()}


# ---------------------------------------------------------------- scores


def _leaves(params: Tensors) -> Tensors:
    return {n: p.detach().requires_grad_(True) for n, p in params.items()}


def snip_scores(loss_fn: Callable, params: Tensors, batch) -> Tensors:
    """SNIP importance as the reference computes it: ``|∂L/∂w|``
    (pruner/utils.py:208-227; the reference drops the paper's ``⊙w``).
    ``loss_fn(params, batch)`` is the scalar loss at ``params``."""
    p = _leaves(params)
    g = torch.autograd.grad(loss_fn(p, batch), list(p.values()))
    return {n: t.abs() for n, t in zip(p, g)}


GRASP_TEMPERATURE = 200.0  # utils.py:234: the loss on model(x) / 200


def grasp_scores(loss_fn: Callable, params: Tensors, batch) -> Tensors:
    """GraSP: ``-w ⊙ (H·ĝ)`` by the exact double backward the reference
    uses (pruner/utils.py:229-245): g = ∂L/∂w with the graph kept, then
    ∂⟨g, stop_grad(g)⟩/∂w. For parity ``loss_fn`` divides the logits by
    :data:`GRASP_TEMPERATURE`."""
    p = _leaves(params)
    leaves = list(p.values())
    g = torch.autograd.grad(loss_fn(p, batch), leaves, create_graph=True)
    inner = sum((a * a.detach()).sum() for a in g)
    hg = torch.autograd.grad(inner, leaves)
    return {n: -(params[n].detach() * h) for n, h in zip(p, hg)}


def synflow_scores(model: torch.nn.Module, params: Tensors,
                   input_shape) -> Tensors:
    """SynFlow: ``|∂R/∂w ⊙ w|`` with ``R = sum(model_|w|(ones))``, the
    model in eval mode (``input_shape`` is NCHW)."""
    p = {n: t.detach().abs().requires_grad_(True) for n, t in params.items()}
    was_training = model.training
    model.eval()
    try:
        device = next(iter(p.values())).device
        ones = torch.ones(input_shape, dtype=torch.float32, device=device)
        r = functional_call(model, p, (ones,)).sum()
        g = torch.autograd.grad(r, list(p.values()))
    finally:
        model.train(was_training)
    return {n: (params[n].detach() * gg).abs() for n, gg in zip(p, g)}


@torch.no_grad()
def prune_by_scores(params: Tensors, scores: Tensors, px: float,
                    mask: Optional[Tensors] = None,
                    n_remaining: Optional[int] = None) -> Tensors:
    """Keep the global top (1 − px of the remaining) conv weights by
    score."""
    return _prune_conv_by_scores(params, lambda n, p: scores[n], px, mask,
                                 n_remaining)


def synflow_prune(model: torch.nn.Module, params: Tensors, px: float,
                  input_shape, iterations: int = 100) -> Tensors:
    """Iterative SynFlow (pruner/utils.py:289-316): ``iterations`` rounds
    at the per-round ratio ``1 − (1 − px)^(1/iterations)``, scores
    recomputed on the masked parameters each round, each round pruning
    that fraction of the remaining weights."""
    each = 1.0 - (1.0 - px) ** (1.0 / iterations)
    mask = None
    n_rem = sum(p.numel() for p in params.values() if is_conv_kernel(p))
    for _ in range(iterations):
        scores = synflow_scores(model, apply_prune_mask(params, mask),
                                input_shape)
        mask = prune_by_scores(params, scores, each, mask, n_remaining=n_rem)
        n_rem = n_rem - round(each * n_rem)
    return mask
