"""Collectives that autograd can see, for the sharded layers of
``dist/{ring_attention,moe,pipeline}.py`` (the counterparts of JAX's
``ppermute``, ``all_to_all`` and ``psum`` inside ``shard_map``).

Each takes one mesh axis (:func:`axis_group`) and is called by every
rank of it, forward and backward alike: a backward that runs on one rank
of the axis must run on all of them, in the same order, or the ranks wait
on each other forever.

A value that every rank of the axis holds alike (a sum over the axis, the
last pipeline stage's answer) is *replicated*; its gradient is taken
once, from the rank's own loss: when every rank computes the same loss
from it, as JAX's transpose of an invariant value assumes, each rank's
incoming gradient is already the whole one, and summing them would count
it once a rank.

The route for CUDA tensors, set here once: gloo (the ranks that share the
card) carries ``all_to_all_single`` with split sizes, and aborts both
ranks on ``batch_isend_irecv``, whose send hands the card's pointer to a
host socket (``writev ... Bad address``; chip_smoke.py phase 9a on the
H100). So the ring shift is an ``all_to_all_single`` in which each rank
sends its whole tensor to the next rank and nothing to the others.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis seen from a rank: its process group, its number of
    ranks and this rank's place along it."""

    group: Optional[dist.ProcessGroup]
    size: int
    index: int


def axis_group(mesh, name: str) -> Axis:
    """The mesh axis ``name`` of this rank. Without a mesh, or along an
    axis of one rank, ``Axis(None, 1, 0)``: the one-process form, on which
    every function here is the identity and runs no collective."""
    if mesh is None or mesh.shape[name] == 1:
        return Axis(None, 1, 0)
    sub = mesh.device_mesh[name]
    return Axis(sub.get_group(), sub.size(), sub.get_local_rank())


def axis_slice(mesh, n: int, name: str) -> slice:
    """This rank's share of ``n`` items split evenly along the mesh axis
    ``name`` (all of them without a mesh); ``ValueError`` when the axis
    does not divide ``n``."""
    size, index = axis_group(mesh, name)[1:]
    if n % size:
        raise ValueError(f"{n} not divisible by {name} axis size {size}")
    k = n // size
    return slice(index * k, (index + 1) * k)


def require_same(values: Sequence[int], axis: Axis, device,
                 message: str) -> None:
    """``ValueError`` on every rank of ``axis`` unless each holds the same
    ``values``: one small all-reduce of their maxima and minima, before
    any data moves, so that no rank raises while the others wait."""
    if axis.size == 1:
        return
    mine = torch.tensor(list(values), dtype=torch.int64, device=device)
    both = torch.cat([mine, -mine])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=axis.group)
    hi, lo = both.view(2, -1).tolist()
    if hi != [-v for v in lo]:
        raise ValueError(f"{message} (from {[-v for v in lo]} to {hi} "
                         f"over the ranks)")


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``x`` of rank ``r − offset`` on rank ``r`` of ``group``."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    flat = x.contiguous().view(-1)
    out = torch.empty_like(flat)
    n = flat.numel()
    send = [n if j == (r + offset) % size else 0 for j in range(size)]
    recv = [n if j == (r - offset) % size else 0 for j in range(size)]
    dist.all_to_all_single(out, flat, recv, send, group=group)
    return out.view(x.shape)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` of rank ``r − 1`` on rank ``r`` of ``axis`` (mod its size):
    JAX's ``ppermute(x, axis, [(j, (j + 1) % p)])``. The backward shifts
    the gradient the other way."""
    if axis.size == 1:
        return x
    return _RingShift.apply(x, axis.group)


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading dimension (of ``axis.size``) to rank
    ``j``; block ``j`` of the result from rank ``j``: JAX's
    ``all_to_all(x, axis, 0, 0, tiled=True)``. Its backward is the same
    exchange of the gradients."""
    if axis.size == 1:
        return x
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()  # before empty_like, which keeps x's strides
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_to_all_single(torch.empty_like(x), x, group=axis.group)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_replicated(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis``, the same on each:
    replicated, so the backward passes each rank its own gradient (the
    module docstring says why)."""
    if axis.size == 1:
        return x
    return _SumReplicated.apply(x, axis.group)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # a tensor this rank did not use still takes part, as zeros
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g
                 for g, (s, d, v) in zip(grads, ctx.like)]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        return (None, *(part.view_as(g) for part, g in zip(
            flat.split([g.numel() for g in grads]), grads)))


def sum_grads(tensors: Sequence[torch.Tensor], axis: Axis) -> list:
    """``tensors`` as they are, whose gradients the backward sums over the
    ranks of ``axis`` (one all-reduce): for parameters replicated over an
    axis that each rank applies to its own rows, as JAX's transpose of a
    replicated input sums it."""
    tensors = list(tensors)
    if axis.size == 1 or not any(t.requires_grad for t in tensors):
        return tensors
    return list(_SumGrads.apply(axis.group, *tensors))


class _FromSource(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, group, src, is_src):
        ctx.is_src = is_src
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        out = x.clone() if is_src else torch.empty_like(x)
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.anchor
        return (grad if ctx.is_src else None,
                torch.zeros(shape, dtype=dtype, device=device),
                None, None, None)


def from_source(x: torch.Tensor, anchor: torch.Tensor, axis: Axis,
                src: int) -> torch.Tensor:
    """The ``x`` of the rank at place ``src`` along ``axis``, on every rank
    of it: replicated, so its gradient goes back to ``src``'s ``x`` from
    ``src``'s own loss. Elsewhere ``x`` gives the shape and dtype only.
    ``anchor`` is a tensor of this rank's graph that must take part in its
    backward (it gets a zero gradient), so that the collectives behind it
    run on every rank."""
    if axis.size == 1:
        return x
    return _FromSource.apply(x, anchor, axis.group,
                             dist.get_global_rank(axis.group, src),
                             axis.index == src)
