"""The ``(data, model)`` mesh (counterpart of ``salun/dist/mesh.py``).

JAX builds a ``Mesh`` of devices with a ``data`` and a ``model`` axis. In
the port a mesh is the process group of a torchrun launch laid out as a
``torch.distributed.device_mesh.DeviceMesh`` of shape ``(data, model)``
(rank ``r`` at ``(r // model, r % model)``): the ``data`` axis shards
batches and, under FSDP, the state (``dist.fsdp``); the ``model`` axis
shards the SD U-Net's attention and feed-forward weights
(``dist.sharding``).

The process group comes first, from ``multihost.initialize``: gloo where
ranks share a card and on the CPU, NCCL with a card a rank.
``init_device_mesh("cuda", ...)`` would pick NCCL by itself, and NCCL
cannot put two ranks on one card, so the ``DeviceMesh`` is built over the
group that is up, and its sub-groups must carry that group's backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``(data, model)`` mesh."""

    data: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None  # the data axis; None: default
    model: int = 1
    device_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        """This rank's coordinate along ``data``."""
        return self.rank // self.model

    @property
    def data_mesh(self):
        """The 1-D ``DeviceMesh`` of this rank's ``data`` axis (FSDP's)."""
        return self.device_mesh["data"]

    @property
    def model_mesh(self):
        """The 1-D ``DeviceMesh`` of this rank's ``model`` axis (TP's)."""
        return self.device_mesh["model"]

    def divides(self, n: int) -> bool:
        return n > 0 and n % self.data == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (``n`` divisible)."""
        if not self.divides(n):
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.data} ranks")
        k = n // self.data
        return slice(self.data_index * k, (self.data_index + 1) * k)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The ``(data, model)`` mesh of the live process group: ``data ×
    model`` must equal its world size (``data`` defaults to ``world //
    model``). Raises when a sub-group comes up on another backend than the
    group's."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group is up; launch with torchrun "
                           "and call salun_torch.dist.multihost.initialize")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"mesh model={model} does not divide {world} ranks")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    dev = torch.device("cpu" if device is None else device)
    backend = dist.get_backend()
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(data, model),
                    mesh_dim_names=("data", "model"))
    for name in ("data", "model"):
        got = dist.get_backend(dm[name].get_group())
        if got != backend:
            raise RuntimeError(f"the mesh's {name} axis came up on {got}, "
                               f"the group is on {backend}")
    group = None if model == 1 else dm["data"].get_group()
    return Mesh(data=data, rank=dist.get_rank(), device=dev, backend=backend,
                group=group, model=model, device_mesh=dm)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` (JAX's ``P("data")``)."""
    return mesh.rows(n)


def shard_batch(mesh: Mesh, batch, dim: int = 0):
    """This rank's rows (axis ``dim``) of every leaf of a host or device
    batch whose axis divides over the mesh; other leaves stay whole."""
    def take(x):
        shape = getattr(x, "shape", None)
        if shape is None or len(shape) <= dim or not mesh.divides(shape[dim]):
            return x
        idx = [slice(None)] * dim + [mesh.rows(shape[dim])]
        return x[tuple(idx)]

    return tree_map(take, batch)


def replicate(mesh: Mesh, tensors, src: int = 0):
    """Broadcast ``tensors`` (a list, or a module's parameters and
    buffers) from rank ``src`` in place; returns them."""
    from .context import broadcast_

    if isinstance(tensors, torch.nn.Module):
        broadcast_(list(tensors.parameters()) + list(tensors.buffers()),
                   src=src, mesh=mesh)
    else:
        broadcast_(list(tensors), src=src, mesh=mesh)
    return tensors


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
