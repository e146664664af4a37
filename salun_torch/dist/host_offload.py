"""Host-memory offload: optimizer state parked in pinned host memory
between steps (counterpart of ``salun/dist/host_offload.py``).

On the card, memory is the scarce resource: Adam's two moments are twice
the parameters (6.9 GB of the SD U-Net's 13.75 GB of parameters, gradients
and moments). Parking them in host memory costs two host↔card copies a
step.

- :func:`to_host` / :func:`to_device` move a list of tensors between the
  card and pinned host memory and keep each one's placement (a DTensor
  shard comes back as the same shard). Where the tensors live on the CPU
  (the tests) the copies are plain ones and nothing is pinned; the device
  to come back to is given explicitly.
- :func:`offloaded` wraps a ``torch.optim`` optimizer: its state tensors
  of at least ``min_size`` elements stay on the host between steps, and
  ``step()`` streams them in and out a bucket of parameters at a time
  (the optimizer stepping only that bucket), so at most one bucket's state
  is on the card at once. A bucket's update is the one the whole step
  makes (the optimizer is elementwise and keeps a step count a
  parameter), so trajectories are bitwise those of the optimizer alone.

JAX's in-graph form (``state_shardings``: placements XLA honours inside a
jitted step) has no counterpart in eager PyTorch; the state composes with
``salun_torch.ckpt.save_sharded`` like any other tensors once streamed in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch

from .fsdp import is_sharded

BUCKET_BYTES = 256 << 20  # the optimizer state streamed in at once


@dataclass
class HostTensor:
    """A DTensor's local shard parked on the host, with its placement."""

    local: torch.Tensor
    mesh: Any
    placements: tuple
    shape: torch.Size
    stride: tuple


def _host_copy(t: torch.Tensor, out: Optional[torch.Tensor] = None):
    if out is None:
        out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                          pin_memory=t.is_cuda)
    out.copy_(t, non_blocking=t.is_cuda)
    return out


def to_host(tensors: Sequence[torch.Tensor], out: Optional[list] = None
            ) -> List:
    """Each tensor in host memory (pinned when it comes from the card),
    written into ``out``'s buffers where given (a :func:`to_host` result of
    the same shapes); a DTensor becomes a :class:`HostTensor` of its local
    shard. Synchronises with the card before returning."""
    res = []
    for i, t in enumerate(tensors):
        prev = out[i] if out is not None else None
        if is_sharded(t):
            buf = _host_copy(t.to_local(), None if prev is None
                             else prev.local)
            res.append(HostTensor(buf, t.device_mesh, tuple(t.placements),
                                  t.shape, t.stride()))
        else:
            res.append(_host_copy(t, prev))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res


def to_device(tensors: Sequence, device) -> List[torch.Tensor]:
    """The inverse of :func:`to_host` onto ``device``: plain tensors come
    back plain, :class:`HostTensor` s as their DTensors."""
    from torch.distributed.tensor import DTensor

    out = []
    for t in tensors:
        if isinstance(t, HostTensor):
            piece = t.local.to(device, non_blocking=True)
            out.append(DTensor.from_local(piece, t.mesh, t.placements,
                                          run_check=False, shape=t.shape,
                                          stride=t.stride))
        else:
            out.append(t.to(device, non_blocking=True))
    return out


class offloaded:
    """``optimizer`` with its large state in host memory between steps.
    ``step()`` walks the parameters in buckets of about ``BUCKET_BYTES`` of
    state: the bucket's state comes in, the optimizer steps the bucket
    alone (the others' gradients hidden for the call), the new state goes
    back out. State tensors below ``min_size`` elements (Adam's step
    counts) never move."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 min_size: int = 1024):
        self.optimizer = optimizer
        self.min_size = min_size
        self._parked = {}

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def _buckets(self, params: list):
        run, size = [], 0
        for p in params:
            nbytes = 2 * p.numel() * p.element_size()
            if run and size + nbytes > BUCKET_BYTES:
                yield run
                run, size = [], 0
            run.append(p)
            size += nbytes
        if run:
            yield run

    def _move(self, params: list, inward: bool) -> None:
        for p in params:
            st = self.optimizer.state.get(p, {})
            keys = [k for k, v in st.items()
                    if isinstance(v, (torch.Tensor, HostTensor))
                    and math.prod(v.shape) >= self.min_size]
            vals = [st[k] for k in keys]
            if inward:
                self._parked[p] = vals  # host buffers, written back into
                home = p.to_local().device if is_sharded(p) else p.device
                st.update(zip(keys, to_device(vals, home)))
            else:
                parked = self._parked.pop(p, None) or None  # None: new state
                st.update(zip(keys, to_host(vals, parked)))

    @torch.no_grad()
    def step(self) -> None:
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        for bucket in self._buckets(params):
            inside = set(map(id, bucket))
            hidden = {}
            for p in params:
                if id(p) not in inside:
                    hidden[p], p.grad = p.grad, None
            self._move(bucket, inward=True)
            try:
                self.optimizer.step()
            finally:
                for p, g in hidden.items():
                    p.grad = g
            self._move(bucket, inward=False)
