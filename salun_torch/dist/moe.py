"""Expert parallelism: a switch-routed MoE layer over a mesh axis
(counterpart of ``salun/dist/moe.py``).

Top-1 routing with a capacity limit (Switch Transformer, Fedus et al.,
arXiv:2101.03961): token dispatch and combine are einsums against a
one-hot dispatch tensor, and the exchange between ranks is one
``all_to_all`` each way (``collectives.all_to_all``, whose backward is the
reverse exchange). Tokens and experts split over the same axis: each rank
holds ``T/p`` tokens and ``E/p`` experts.

The router's load-balancing term ``E · Σ_e f_e · P_e`` (the share of
tokens sent to expert e times e's mean router probability) is taken over
the axis's global batch, so it is the same on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .collectives import (all_to_all, axis_group, axis_slice, require_same,
                          sum_grads, sum_replicated)


def expert_sharding(mesh, n_experts: int, axis: str = "data") -> slice:
    """This rank's slice of the stacked expert dimension of ``n_experts``
    over ``axis`` (JAX's ``P(axis)`` on it)."""
    return axis_slice(mesh, n_experts, axis)


def moe_apply(expert_fn: Callable, expert_params: dict,
              gate_w: torch.Tensor, x: torch.Tensor, mesh=None, *,
              axis: str = "data", capacity_factor: Optional[float] = None,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-MoE layer: each token of ``x`` to one of ``E`` experts.

    Every rank of ``axis`` calls it with its own tokens ``x`` [t, d] (an
    equal share of the T) and its own experts: ``expert_params``, a dict of
    tensors whose leading dimension is this rank's E/p experts
    (:func:`expert_sharding`). ``gate_w`` [d, E] is the router, the same on
    every rank. ``expert_fn(params, h)`` is one expert ([n, d] → [n, d]),
    applied to the stacked local experts by ``torch.func.vmap``.
    ``capacity`` is the tokens an expert takes from each rank (default
    ``max(1, int(capacity_factor · t / E + 0.5))`` with factor 1.25);
    tokens past it are dropped and come out as 0.

    Returns this rank's ``y`` [t, d] and the aux loss, the same on every
    rank; add ``aux_weight · aux`` to each rank's loss. Gradients: x's and
    the local experts' on their rank; ``gate_w``'s summed over the axis
    inside the backward, so every rank holds the whole of it, as JAX's
    replicated router does. Without a mesh it is the one-process form.
    ``ValueError`` on every rank when the axis does not divide E or the
    tokens, before any data moves."""
    ax = axis_group(mesh, axis)
    p = ax.size
    n_experts = gate_w.shape[1]
    e_local = next(iter(expert_params.values())).shape[0]
    if n_experts % p or e_local * p != n_experts:
        raise ValueError(f"{n_experts} experts not divisible by {axis} axis "
                         f"size {p} into shards of the {e_local} held here")
    t, d = x.shape
    require_same((t,), ax, x.device,
                 f"tokens not divisible by {axis} axis size {p}: the ranks "
                 f"hold unequal shares")
    if capacity is None:
        factor = 1.25 if capacity_factor is None else capacity_factor
        capacity = max(1, int(factor * t / n_experts + 0.5))
    (gate_w,) = sum_grads([gate_w], ax)

    # route (top-1 switch)
    probs = torch.softmax((x @ gate_w).to(torch.float32), dim=-1)  # [t, E]
    idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, idx[:, None])[:, 0]
    onehot = F.one_hot(idx, n_experts).to(torch.float32)
    # each token's place in its expert's send buffer; past the capacity it
    # is dropped (output 0, the switch convention)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = (pos >= 0) & (pos < capacity)
    dispatch = (onehot * keep).to(x.dtype)[:, :, None] * F.one_hot(
        pos.clamp(0, capacity - 1).long(), capacity).to(x.dtype)

    # tokens → their expert's rank; recv[j, e]: rank j's tokens for local
    # expert e
    sent = torch.einsum("td,tec->ecd", x, dispatch)
    recv = all_to_all(sent.reshape(p, e_local, capacity, d), ax)
    inputs = recv.transpose(0, 1).reshape(e_local, p * capacity, d)
    outputs = torch.func.vmap(expert_fn)(expert_params, inputs)
    back = outputs.reshape(e_local, p, capacity, d).transpose(0, 1)
    ret = all_to_all(back, ax).reshape(n_experts, capacity, d)
    combine = dispatch * gate.to(x.dtype)[:, None, None]
    y = torch.einsum("ecd,tec->td", ret, combine)

    # load balance over the global batch: one all-reduce of both sums and
    # the token count
    stats = torch.cat([onehot.sum(0), probs.sum(0),
                       torch.full((1,), float(t), device=x.device)])
    stats = sum_replicated(stats, ax)
    f = stats[:n_experts] / stats[-1]
    pmean = stats[n_experts:2 * n_experts] / stats[-1]
    aux = n_experts * torch.sum(f * pmean)
    return y, aux
