"""Pipeline parallelism (GPipe microbatching) over a mesh axis (counterpart
of ``salun/dist/pipeline.py``).

With ``S`` stages, one a rank of the axis, and ``M`` microbatches, the
pipeline runs ``M + S − 1`` ticks (Huang et al., arXiv:1811.06965). On
each tick stage 0 takes the next microbatch, every stage applies its
stage to the activation it holds, the last stage keeps its result, and
the activation moves one stage down the ring (``collectives.ring_shift``,
whose backward is the reverse pipeline). Microbatch ``m`` reaches stage
``s`` at tick ``m + s``; a stage skips the ticks on which it holds no
microbatch (JAX computes them and throws the result away), but every rank
joins every shift, so the ring stays in step.

In eager torch only the last stage holds the answer. It is broadcast to
every rank of the axis as a replicated value (``collectives.from_source``),
and the ticks' shifts chain each rank's graph from its first tick to its
last, so one ``backward`` on every rank runs every shift's backward in the
same order on each.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .collectives import (axis_group, axis_slice, from_source, ring_shift,
                          sum_grads)


def stack_stage_params(stages: Sequence[dict]) -> dict:
    """Stack per-stage parameter dicts (one structure, one shape each)
    along a new leading ``stage`` dimension."""
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def stage_sharding(mesh, n_stages: int, axis: str = "model") -> slice:
    """This rank's slice of the stacked ``stage`` dimension of
    ``n_stages`` over ``axis`` (JAX's ``P(axis)`` on it)."""
    return axis_slice(mesh, n_stages, axis)


class _Keep(torch.autograd.Function):
    """``value``, with ``dep`` kept in the graph at a zero gradient: stage
    0 drops the activation the ring brings it but must still join that
    shift's backward."""

    @staticmethod
    def forward(ctx, value, dep):
        ctx.like = (dep.shape, dep.dtype, dep.device)
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor,
                   mesh=None, *, axis: str = "model",
                   num_microbatches: Optional[int] = None,
                   batch_axis: Optional[str] = None,
                   remat: bool = True) -> torch.Tensor:
    """Apply the ``S`` stages of ``axis`` to ``x`` [B, ...], pipelined.

    Every rank of ``axis`` calls it with the same ``x`` and its own stage:
    ``stage_params``, a dict of tensors with a leading stage dimension of
    1 (its :func:`stage_sharding` slice of the :func:`stack_stage_params`
    stack), so S is the axis size. ``stage_fn(params, h) -> h`` is one
    stage (shape-preserving). ``num_microbatches`` (default S) must divide
    B. ``remat`` recomputes each stage's activations in the backward
    (``torch.utils.checkpoint``).

    Returns the last stage's output [B, ...] on every rank of ``axis``:
    replicated, so its gradient is the last stage's own (each rank calls
    ``backward`` on the same loss; it is not counted S times). The stage
    gradients land on their own rank, x's on stage 0's.

    With ``batch_axis`` (dp × pp on a (data, pipe) mesh), ``x`` is this
    rank's rows along ``batch_axis`` (``mesh.rows``), each microbatch a
    share of them, and the stage parameters, replicated over
    ``batch_axis``, get their gradients summed over it inside the backward
    (one all-reduce), as JAX's transpose of a replicated input does: the
    caller takes no further all-reduce over ``batch_axis``.

    ``ValueError`` when the leading stage dimension is not 1 (S differs
    from the axis size) or when M does not divide B."""
    ax = axis_group(mesh, axis)
    n_stages, s = ax.size, ax.index
    lead = next(iter(stage_params.values())).shape[0]
    if lead != 1:
        raise ValueError(f"stage_params leading dim {lead} on this rank: "
                         f"{axis} axis size {n_stages} takes one stage a "
                         f"rank")
    m = n_stages if num_microbatches is None else num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"num_microbatches {m}")
    names = list(stage_params)
    tensors = [stage_params[k][0] for k in names]
    if batch_axis is not None:
        tensors = sum_grads(tensors, axis_group(mesh, batch_axis))
    params = dict(zip(names, tensors))
    xm = x.reshape((m, x.shape[0] // m) + x.shape[1:])
    # a stage's first ticks pass zeros on; they take part in the graph, so
    # that those shifts run their backward here as on the ranks that
    # sent real activations through them
    state = torch.zeros_like(xm[0]).requires_grad_(
        torch.is_grad_enabled()
        and any(t.requires_grad for t in tensors + [x]))
    outs = []
    for t in range(m + n_stages - 1):
        if s == 0:
            mb = xm[min(t, m - 1)]
            state = mb if t == 0 else _Keep.apply(mb, state)
        if s <= t < s + m:  # this stage holds microbatch t − s
            y = (checkpoint(stage_fn, params, state, use_reentrant=False)
                 if remat else stage_fn(params, state))
        else:
            y = state
        if s == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)
        if t < m + n_stages - 2:  # nothing is left to pass on the last tick
            state = ring_shift(y, ax)
    last = torch.cat(outs) if outs else torch.empty(
        (x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    return from_source(last, y, ax, n_stages - 1)
