"""FSDP (ZeRO-3) over the ``data`` axis: counterpart of
``salun/dist/fsdp.py``.

The JAX package shards each parameter's largest ``data``-divisible axis and
lets GSPMD insert the all-gathers and reduce-scatters. The port keeps that
layout rule (:func:`fsdp_pspecs`) and hands it to FSDP2
(``torch.distributed.fsdp.fully_shard``) through ``shard_placement_fn``:
each unit (the SD U-Net's ResBlocks and SpatialTransformers, then the
root) all-gathers its parameters before its forward and again before its
backward, and reduce-scatters their gradients after it. Parameters below
``min_size`` elements stay whole on every rank (``ignored_params``); their
gradients go through ``context.all_reduce_grads``.

What the port's callers rely on:

- Gradients are *summed* over the ranks, not averaged: the losses already
  carry the global batch's denominator (``context.share``). FSDP2's
  reduce-scatter runs as a sum with a divide factor of 1
  (:func:`set_grad_sum`); a step whose batch stays whole on every rank
  divides by the rank count instead, which gives back exactly the
  gradient every rank computed.
- Gathers for readers (:func:`full_tensor`, :func:`full_state_dict`) use
  ``all_gather_into_tensor`` of ``torch.distributed``, not DTensor's
  ``full_tensor``: gloo carries the former for CUDA tensors, while the
  functional all-gather under DTensor crashed gloo on CUDA (torch 2.11).
- Parameter-shaped state (the saliency mask, θ₀) takes each parameter's
  placement by slicing (:func:`place_like`), with no collective.

Masks and Adam's moments are parameter-shaped, so they shard with the
parameters.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# the SD U-Net's FSDP units, by class name (the root is one more)
SD_UNITS = ("ResBlock", "SpatialTransformer")


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (a parameter, gradient or state under
    FSDP or TP)."""
    return isinstance(t, _dtensor_type())


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``t`` (``t`` itself when it is whole)."""
    return t.to_local() if is_sharded(t) else t


def fsdp_pspecs(module: nn.Module, mesh,
                min_size: int = 2 ** 12) -> Dict[str, Optional[int]]:
    """``{parameter name: the dimension to shard, or None}``: JAX's rule on
    the port's layouts. The largest dimension that the ``data`` size
    divides (the first of equal ones); None below ``min_size`` elements,
    when none divides, or when the axis has one rank. The port's weights
    are ``[out, in]``/OIHW where JAX's are ``[in, out]``/HWIO, so on a tie
    (a 3×3 conv with C_in = C_out) the two pick different logical axes of
    the same size."""
    n = mesh.data

    def spec_for(v: torch.Tensor) -> Optional[int]:
        if v.numel() < min_size or n == 1:
            return None
        for i in sorted(range(v.dim()), key=lambda i: -v.shape[i]):
            if v.shape[i] % n == 0:
                return i
        return None

    return {name: spec_for(p) for name, p in module.named_parameters()}


def count_sharded(pspecs: Dict[str, Optional[int]]) -> int:
    return sum(1 for d in pspecs.values() if d is not None)


def shard_fsdp(module: nn.Module, mesh, pspecs=None,
               reshard_after_forward: bool = False) -> nn.Module:
    """FSDP2 over ``mesh``'s ``data`` axis, in place: ``fully_shard`` on
    every submodule whose class is named in ``SD_UNITS``, then on ``module``,
    each parameter sharded along its :func:`fsdp_pspecs` dimension and the
    replicated ones left out (``ignored_params``). Returns ``module``.

    With ``reshard_after_forward`` False a unit gathers its parameters
    once a step, at its first forward, and frees them after its backward:
    the later forwards of the step (random_label's pseudo and remain
    passes) and remat's recomputes reuse them, as XLA reuses one
    all-gather within a jitted step. A module that runs no backward (ESD's
    teacher) takes True, or its gathered parameters would stay."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    pspecs = fsdp_pspecs(module, mesh) if pspecs is None else pspecs
    named = dict(module.named_parameters())
    dims = {id(named[n]): d for n, d in pspecs.items() if d is not None}
    ignored = {named[n] for n, d in pspecs.items() if d is None}
    if not dims:  # nothing to shard (one rank, or only small leaves)
        return module

    def placement(p):
        return Shard(dims[id(p)])

    kw = dict(mesh=mesh.data_mesh, shard_placement_fn=placement,
              ignored_params=ignored,
              reshard_after_forward=reshard_after_forward)
    for m in list(module.modules()):
        if m is not module and type(m).__name__ in SD_UNITS:
            fully_shard(m, **kw)
    fully_shard(module, **kw)
    for m in fsdp_units(module):
        m.set_force_sum_reduction_for_comms(True)
    set_grad_sum(module, 1.0)
    return module


def fsdp_units(module: nn.Module) -> list:
    from torch.distributed.fsdp import FSDPModule

    return [m for m in module.modules() if isinstance(m, FSDPModule)]


def set_grad_sum(module: nn.Module, divide: float = 1.0) -> None:
    """What FSDP2 divides the sum of the ranks' gradients of ``module``'s
    sharded parameters by in the next backward: 1 when each rank computed
    its rows of a sharded batch, the rank count when every rank computed
    the whole batch (then it gives the ranks' common gradient back: a power
    of two, so exactly)."""
    for m in fsdp_units(module):
        m.set_gradient_divide_factor(float(divide))


def replicated_params(params: Iterable[torch.Tensor]) -> list:
    """The parameters FSDP left whole (their gradients need an
    all-reduce of their own)."""
    return [p for p in params if not is_sharded(p)]


def place_like(full: torch.Tensor, ref) -> torch.Tensor:
    """``full`` (a whole tensor of ``ref``'s shape) with ``ref``'s placement
    and device: this rank's chunk as a DTensor when ``ref`` is one (no
    collective), else ``full`` on ``ref``'s device."""
    if not is_sharded(ref):
        return full.to(ref.device)
    from torch.distributed.tensor import DTensor, Shard

    (placement,) = ref.placements
    piece = full
    if isinstance(placement, Shard):
        mesh = ref.device_mesh
        piece = full.chunk(mesh.size(), placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(piece.contiguous().to(ref.to_local().device),
                              ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` on every rank of its mesh (a collective when
    ``t`` is sharded), detached: the pieces of a 1-D ``Shard(d)`` DTensor
    gathered by ``all_gather_into_tensor`` along ``d``."""
    if not is_sharded(t):
        return t
    from torch.distributed.tensor import Shard

    (placement,) = t.placements
    piece = t.to_local().detach()
    if not isinstance(placement, Shard):
        return piece
    mesh = t.device_mesh
    d = placement.dim
    moved = piece.movedim(d, 0).contiguous()
    out = torch.empty((mesh.size() * moved.shape[0],) + moved.shape[1:],
                      dtype=moved.dtype, device=moved.device)
    dist.all_gather_into_tensor(out, moved, group=mesh.get_group())
    return out.movedim(0, d).contiguous()


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded tensor gathered whole, on
    every rank (a collective: every rank calls it)."""
    with torch.no_grad():
        return {k: full_tensor(v.detach())
                for k, v in module.state_dict().items()}


def local_pieces(tensors: Sequence[torch.Tensor], mesh) -> list:
    """The pieces of ``tensors`` this rank contributes to a sum over the
    ``data`` axis in which each element counts once: its shard of every
    sharded tensor, and the whole tensors on ``data`` index 0 only."""
    first = mesh.data_index == 0
    return [local(t) for t in tensors if is_sharded(t) or first]
