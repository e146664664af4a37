"""Tensor parallelism over the ``model`` axis for the SD U-Net: counterpart
of ``salun/dist/sharding.py``.

JAX's rule in CompVis names, on the port's ``[out, in]`` weights:

- column-parallel, ``Shard(0)`` (JAX's ``P(None, "model")`` of ``[in,
  out]``): ``to_q``, ``to_k``, ``to_v`` of every attention (heads split
  over the ranks) and the GEGLU's ``ff.net.0.proj``;
- row-parallel, ``Shard(1)`` (JAX's ``P("model", None)``): ``to_out.0``
  and ``ff.net.2``, each followed by one all-reduce;
- everything else (convolutions, norms, embeddings) replicated.

:func:`shard_params` applies it with ``parallelize_module``
(``torch.distributed.tensor.parallel``'s ``ColwiseParallel`` and
``RowwiseParallel``). Two things JAX gets from GSPMD are written out
here:

- A rank's attention holds ``heads / model`` heads: ``CrossAttention``
  takes its head count from the width of its local projections.
- The GEGLU splits ``proj(x)`` into ``h, gate`` by halves. A plain row
  shard of ``proj`` would give one rank all of ``h`` and the other all of
  ``gate``; so its rows are permuted before sharding, rank ``r``'s block
  being ``[h_r; gate_r]``, and the permutation is undone wherever the
  whole tensor is read (:func:`full_state_dict`, :func:`full_grads`) or
  written (:func:`load_full`). ``ColwiseParallel`` shards the GEGLU's bias
  with its rows (JAX leaves the bias replicated and lets GSPMD slice it).

No CLI takes a ``model`` axis (neither does the JAX package's).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .fsdp import full_tensor, is_sharded, local
# JAX's sharding module has a count_sharded of its own; the rule is shared
from .fsdp import count_sharded  # noqa: F401

COLUMN_PARALLEL = ("to_q", "to_k", "to_v", "ff.net.0.proj")
ROW_PARALLEL = ("to_out.0", "ff.net.2")
GEGLU = "ff.net.0.proj"


def _style(module_name: str) -> Optional[str]:
    if module_name.endswith(tuple("." + s for s in COLUMN_PARALLEL)):
        return "column"
    if module_name.endswith(tuple("." + s for s in ROW_PARALLEL)):
        return "row"
    return None


def sd_unet_pspecs(unet: nn.Module) -> Dict[str, Optional[int]]:
    """``{parameter name: the sharded dimension, or None}``: 0 for the
    column-parallel weights and the GEGLU's bias, 1 for the row-parallel
    weights, None (replicated) for the rest."""
    specs = {}
    for mname, m in unet.named_modules():
        style = _style(mname)
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if style == "column":
                specs[name] = 0
            elif style == "row" and pname == "weight":
                specs[name] = 1
    return {n: specs.get(n) for n, _ in unet.named_parameters()}


def sd_unet_plan(unet: nn.Module) -> dict:
    """``{module name: ColwiseParallel() | RowwiseParallel()}`` for
    ``parallelize_module``."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)

    plan = {}
    for name, _ in unet.named_modules():
        style = _style(name)
        if style is not None:
            plan[name] = ColwiseParallel() if style == "column" \
                else RowwiseParallel()
    return plan


def geglu_perm(rows: int, parts: int) -> torch.Tensor:
    """The row order of a GEGLU ``proj`` (``rows = 2·inner``) whose ``parts``
    equal blocks are each ``[h_r; gate_r]``: new row ``i`` is old row
    ``perm[i]``."""
    inner = rows // 2
    c = inner // parts
    return torch.cat([torch.cat([torch.arange(r * c, (r + 1) * c),
                                 inner + torch.arange(r * c, (r + 1) * c)])
                      for r in range(parts)])


def _geglu_names(unet: nn.Module) -> set:
    return {f"{n}.{p}" for n, m in unet.named_modules()
            if n.endswith("." + GEGLU) for p in ("weight", "bias")}


def shard_params(unet: nn.Module, mesh) -> nn.Module:
    """The U-Net tensor-parallel over ``mesh``'s ``model`` axis, in place
    (every rank holds the same weights before: no collective). Returns
    ``unet``."""
    from torch.distributed.tensor.parallel import parallelize_module

    m = mesh.model
    if m == 1:
        return unet
    for name, mod in unet.named_modules():
        if name.endswith("." + GEGLU):
            perm = geglu_perm(mod.weight.shape[0], m)
            with torch.no_grad():
                for p in (mod.weight, mod.bias):
                    p.copy_(p[perm.to(p.device)])
    parallelize_module(unet, mesh.model_mesh, sd_unet_plan(unet),
                       src_data_rank=None)
    return unet


def _unpermute(name: str, t: torch.Tensor, parts: int, names: set):
    if name not in names or parts == 1:
        return t
    inv = torch.argsort(geglu_perm(t.shape[0], parts)).to(t.device)
    return t[inv]


def _parts(t) -> int:
    """The ranks of the ``model`` axis ``t`` is split over (1 when whole or
    sharded over another axis)."""
    if is_sharded(t) and t.device_mesh.mesh_dim_names == ("model",):
        return t.device_mesh.size()
    return 1


def full_state_dict(unet: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer whole, in CompVis row order, on every
    rank (a collective)."""
    names = _geglu_names(unet)
    with torch.no_grad():
        return {k: _unpermute(k, full_tensor(v.detach()), _parts(v), names)
                for k, v in unet.state_dict().items()}


def full_grads(unet: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient whole, in CompVis row order, on every
    rank (a collective); parameters without one are left out."""
    names = _geglu_names(unet)
    return {n: _unpermute(n, full_tensor(p.grad), _parts(p.grad), names)
            for n, p in unet.named_parameters() if p.grad is not None}


def load_full(unet: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Write whole tensors (CompVis row order) into the sharded U-Net's
    parameters of the same names: each rank copies its own piece (no
    collective)."""
    from .fsdp import place_like

    names = _geglu_names(unet)
    params = dict(unet.named_parameters())
    with torch.no_grad():
        for k, full in state.items():
            p = params[k]
            if k in names and _parts(p) > 1:
                full = full[geglu_perm(full.shape[0], _parts(p))]
            local(p).copy_(local(place_like(full, p)))
