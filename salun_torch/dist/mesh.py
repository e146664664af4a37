"""The data-parallel mesh (counterpart of ``salun/dist/mesh.py``).

JAX builds a ``Mesh`` of devices with a ``data`` and a ``model`` axis. In
the port a mesh is the process group of a torchrun launch: one rank per
shard of the batch, so the ``data`` axis is the world size and ``model``
is 1. Tensor parallelism (``model > 1``) and a
``torch.distributed.device_mesh.DeviceMesh`` wait for the FSDP slice:
``init_device_mesh("cuda", ...)`` picks NCCL, which cannot put two ranks
on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``(data, model)`` mesh."""

    data: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None  # None: the default group
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def divides(self, n: int) -> bool:
        return n > 0 and n % self.data == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (``n`` divisible)."""
        if not self.divides(n):
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.data} ranks")
        k = n // self.data
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The mesh of the live process group: ``data`` must equal its world
    size (default: the world size). ``model > 1`` raises: tensor
    parallelism is not ported yet."""
    if model != 1:
        raise NotImplementedError("a model axis (tensor parallelism) is not "
                                  "ported yet (ROADMAP E23)")
    if not dist.is_initialized():
        raise RuntimeError("no process group is up; launch with torchrun "
                           "and call salun_torch.dist.multihost.initialize")
    world = dist.get_world_size()
    data = world if data is None else data
    if data != world:
        raise ValueError(f"mesh data={data} != {world} ranks")
    dev = torch.device("cpu" if device is None else device)
    return Mesh(data=data, rank=dist.get_rank(), device=dev,
                backend=dist.get_backend())


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
