"""The data-parallel context of a CLI run (counterpart of
``salun/dist/context.py``).

``--dp N`` runs N processes under ``torchrun --nproc_per_node N``. A CLI
builds the mesh with :func:`mesh_from_flags` and *activates* it for the
run; the batch-ingestion sites of the port (the classification trainer
and validator, the DDPM runner's losses, samplers and FIM, the SD
trainers and samplers) then keep this rank's rows of each batch. The JAX
package gets the rest from GSPMD; here it is written out, and activating a
mesh still changes placement only, not the math:

1. Every rank sees the whole global batch and keeps its own rows
   (:func:`rows`, :func:`ingest`, :func:`constrain_batch`). A batch whose
   size does not divide over the ranks stays whole on every rank, and its
   step runs no collective. Random draws are made for the global batch
   from the same generator on every rank and then sliced: the callers
   draw before they slice, and the draws made inside a model
   (:func:`rand`, :func:`randn`) do so within :func:`sharded`. Loss
   denominators are those of the global batch (:func:`share`).
2. Gradients are summed over the ranks before anything reads them
   (:func:`all_reduce_`, in buckets), and saliency sums once before
   ``|·|``.
3. BatchNorm in train mode takes its moments over the global batch
   (:class:`GlobalBatchNorm2d`, within :func:`sharded`).
4. Rank 0's initial state is broadcast (:func:`place_replicated`); a sum
   over the ranks leaves the same bits on each, so the replicas stay
   bitwise equal without further traffic.
5. Only rank 0 writes (:func:`is_writer`); the others wait at
   :func:`barrier`. Rows computed apart come back to every rank through
   :func:`gather_rows`.

The collectives here are ``all_reduce`` and ``broadcast``; under
``--fsdp`` (``salun_torch.dist.fsdp``) FSDP2 adds ``all_gather_into_tensor``
and ``reduce_scatter_tensor``. gloo carries all four for CUDA tensors, so
two ranks may share one card.

Design note: an ambient context (module globals and context managers), as
in JAX, rather than a mesh argument threaded through the method zoo's
uniform signatures.
"""

from __future__ import annotations

import contextlib
import sys
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from . import multihost
from .mesh import Mesh, make_mesh

_ACTIVE: Optional[Mesh] = None
# (lo, hi, n): this rank's rows of the global batch of n the current
# sharded computation runs on (see ``sharded``)
_ROWS: Optional[tuple] = None

BUCKET_BYTES = 256 << 20  # all-reduce and broadcast bucket size


def active_mesh() -> Optional[Mesh]:
    """The mesh activated by the current CLI run, or None (one process)."""
    return _ACTIVE


@contextlib.contextmanager
def activate(mesh: Optional[Mesh]):
    """Activate ``mesh`` for the dynamic extent (None = no-op)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def mesh_from_flags(dp: int = 0, device="cuda") -> Optional[Mesh]:
    """The ``(data,)`` mesh a ``--dp N`` flag asks for, on ``device``.

    ``dp`` of 0 or 1 returns None (the single-process path). ``dp > 1``
    needs a torchrun launch of exactly ``dp`` processes and raises
    ``ValueError`` otherwise; it brings up the process group
    (:func:`salun_torch.dist.multihost.initialize`)."""
    if not dp or dp <= 1:
        return None
    env = multihost.launch_env()
    if env is None:
        raise ValueError(f"--dp {dp} needs {dp} processes: launch with "
                         f"torchrun --nproc_per_node {dp} -m <cli> ... "
                         f"--dp {dp}")
    if env["world"] != dp:
        raise ValueError(f"--dp {dp} but torchrun started {env['world']} "
                         f"processes")
    multihost.initialize(device)
    return make_mesh(data=dp, device=multihost.rank_device(device, env))


def run(dp: int, device, fn):
    """``fn(device)`` with the ``--dp`` mesh active: the body of a CLI's
    ``main``. ``device`` is this rank's (:func:`mesh_from_flags`) or, with
    one process, ``device`` resolved (``salun_torch.utils.device``). A
    process group this call brings up is destroyed at the end, whatever
    happens; one that was up before (a launch running several CLIs in
    turn) stays up."""
    from salun_torch.utils.device import resolve_device

    dev = resolve_device(device)
    owned = not dist.is_initialized()
    mesh = mesh_from_flags(dp, dev)
    try:
        with activate(mesh):
            return fn(dev if mesh is None else mesh.device)
    finally:
        if mesh is not None and owned:
            multihost.shutdown()


def is_writer() -> bool:
    """True on the rank that writes files: rank 0, or the only process."""
    return _ACTIVE is None or _ACTIVE.rank == 0


# ------------------------------------------------------------ rows


def rows(n: int) -> Optional[slice]:
    """This rank's rows of a global batch of ``n``, or None: no active
    mesh, or ``n`` does not divide (the batch stays whole)."""
    if _ACTIVE is None or not _ACTIVE.divides(n):
        return None
    return _ACTIVE.rows(n)


def skips(n: int) -> bool:
    """True on the ranks other than 0 where a batch of ``n`` stays whole:
    a computation that sums such a batch into a quantity the ranks later
    all-reduce leaves it to rank 0."""
    return _ACTIVE is not None and rows(n) is None and _ACTIVE.rank != 0


def share(n: int) -> float:
    """This rank's fraction of a batch of ``n``: a mean over its rows times
    ``share(n)`` summed over the ranks is the global mean."""
    sl = rows(n)
    return 1.0 if sl is None else (sl.stop - sl.start) / n


def whole_share(n: int) -> float:
    """The weight of a term every rank computes whole in a step whose batch
    of ``n`` shards (a penalty on the parameters): ``1/N``, so the sum over
    the ranks is the term; 1 when the batch stays whole."""
    return 1.0 if rows(n) is None else 1.0 / _ACTIVE.data


def step_sharded(*sizes) -> bool:
    """Whether a step over batches of ``sizes`` rows shards (and so sums
    its gradients over the ranks); raises when some divide and some do
    not."""
    flags = {rows(n) is not None for n in sizes}
    if len(flags) > 1:
        raise ValueError(f"the batches of one step ({sizes} rows) must all "
                         f"divide over {_ACTIVE.data} ranks, or none")
    return flags == {True}


def ingest(batch, dim: int = 0):
    """This rank's rows (axis ``dim``) of every leaf of ``batch`` whose axis
    divides over the active mesh; the batch unchanged without one."""
    if _ACTIVE is None:
        return batch
    from .mesh import shard_batch

    return shard_batch(_ACTIVE, batch, dim)


def constrain_batch(x, dim: int = 0):
    """:func:`ingest` for one tensor created on the device (the initial
    noise of a sampling chain)."""
    return ingest(x, dim)


@contextlib.contextmanager
def sharded(n: int):
    """The extent of a computation on this rank's rows of a global batch of
    ``n``; yields the rows, or None when the batch stays whole (then
    nothing changes). Within it, :func:`rand` and :func:`randn` draw for
    the global batch and keep these rows, and :class:`GlobalBatchNorm2d`
    in train mode takes the global batch's moments."""
    global _ROWS
    sl = rows(n)
    prev = _ROWS
    _ROWS = None if sl is None else (sl.start, sl.stop, n)
    try:
        yield sl
    finally:
        _ROWS = prev


def _global_draw(draw, shape, **kw):
    shape = tuple(shape)
    if _ROWS is None:
        return draw(shape, **kw)
    lo, hi, n = _ROWS
    if not shape or shape[0] != hi - lo:
        raise ValueError(f"a draw of shape {shape} within a shard of "
                         f"{hi - lo} rows")
    return draw((n,) + shape[1:], **kw)[lo:hi]


def rand(shape, *, generator=None, device=None) -> torch.Tensor:
    """``torch.rand``; within :func:`sharded`, drawn for the global batch
    and sliced to this rank's rows (axis 0 of ``shape`` is the local row
    count)."""
    return _global_draw(torch.rand, shape, generator=generator,
                        device=device)


def randn(shape, *, generator=None, device=None,
          dtype=None) -> torch.Tensor:
    """``torch.randn``, drawn as :func:`rand` is."""
    return _global_draw(torch.randn, shape, generator=generator,
                        device=device, dtype=dtype)


def randint(low: int, high: int, shape, *, generator=None,
            device=None) -> torch.Tensor:
    """``torch.randint``, drawn as :func:`rand` is."""
    return _global_draw(lambda sh, **kw: torch.randint(low, high, sh, **kw),
                        shape, generator=generator, device=device)


# ------------------------------------------------------------ collectives


def _group():
    return _ACTIVE.group if _ACTIVE is not None else None


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Consecutive runs of tensors of one dtype and device, each at most
    ``bucket_bytes`` (a larger tensor forms a run of its own)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (size + nbytes > bucket_bytes or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _bucketed(op, tensors: Sequence[torch.Tensor], bucket_bytes: int):
    for run in _buckets(tensors, bucket_bytes):
        if len(run) == 1 and run[0].is_contiguous():
            op(run[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        o = 0
        for t in run:
            k = t.numel()
            t.copy_(flat[o:o + k].view_as(t))
            o += k


def all_reduce_(tensors: Sequence[torch.Tensor],
                bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each tensor over the ranks of the active mesh, in place, in
    buckets of at most ``bucket_bytes``; a no-op without a mesh. Every
    rank ends with the same bits."""
    if _ACTIVE is None:
        return
    group = _group()
    with torch.no_grad():
        _bucketed(lambda t: dist.all_reduce(t, group=group), list(tensors),
                  bucket_bytes)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               mesh: Optional[Mesh] = None,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank of the launch
    (both mesh axes), in place."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return
    with torch.no_grad():
        _bucketed(lambda t: dist.broadcast(t, src=src), list(tensors),
                  bucket_bytes)


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum the ``.grad`` of each parameter over the ranks, in place (a
    parameter without one gets zeros first, so every rank reduces the same
    tensors)."""
    if _ACTIVE is None:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    all_reduce_(grads)


def sum_scalars(*values) -> list:
    """Sum a few scalar tensors over the ranks in one collective; returns
    them as 0-dim tensors (unchanged without a mesh)."""
    if _ACTIVE is None:
        return list(values)
    buf = torch.stack([torch.as_tensor(v, dtype=torch.float64).reshape(())
                       .to(_ACTIVE.device) for v in values])
    dist.all_reduce(buf, group=_group())
    return list(buf.unbind())


def gather_rows(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """The global batch of ``n`` from each rank's rows ``x`` (its
    :func:`rows` of axis ``dim``), on every rank: the rows are put into
    zeros and summed over the ranks, which adds only zeros. ``x`` is
    returned unchanged when the batch was not sharded."""
    sl = rows(n)
    if sl is None:
        return x
    shape = list(x.shape)
    shape[dim] = n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    idx = [slice(None)] * dim + [sl]
    out[tuple(idx)] = x
    dist.all_reduce(out, group=_group())
    return out


def barrier() -> None:
    """Wait for every rank (one all-reduce of a scalar)."""
    if _ACTIVE is not None:
        dist.all_reduce(torch.zeros(1, device=_ACTIVE.device),
                        group=_group())


def digest(tensors: Sequence[torch.Tensor]) -> int:
    """A 64-bit checksum of the bits of ``tensors``: each tensor's bytes
    as int32 words, weighted by their position, summed with wrap-around
    (one flipped bit changes it)."""
    total = torch.zeros((), dtype=torch.int64)
    for i, t in enumerate(tensors):
        words = t.detach().reshape(-1).contiguous().view(torch.uint8)
        words = torch.nn.functional.pad(words, (0, -words.numel() % 4))
        words = words.view(torch.int32).to(torch.int64)
        pos = torch.arange(1, words.numel() + 1, device=words.device)
        total += ((words * (pos * 2 + 1 + 2 * i)).sum()).cpu()
    return int(total)


def check_replicas(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless every rank holds the same bits of ``tensors`` as rank
    0 (their :func:`digest`s, one broadcast); prints this rank's digest.
    A no-op without a mesh."""
    if _ACTIVE is None:
        return
    tensors = list(tensors)
    mine = digest(tensors)
    ref = torch.tensor([mine], dtype=torch.int64, device=_ACTIVE.device)
    dist.broadcast(ref, src=0, group=_group())
    # one write, so the ranks' lines do not interleave
    sys.stdout.write(f"rank {_ACTIVE.rank}: {what} digest "
                     f"{mine & (2**64 - 1):016x}\n")
    sys.stdout.flush()
    if int(ref) != mine:
        raise RuntimeError(f"rank {_ACTIVE.rank}'s {what} differ from rank "
                           f"0's: the replicas diverged")


def place_replicated(module_or_tensors, mesh: Optional[Mesh] = None):
    """Rank 0's parameters and buffers (of a module, or a list of tensors)
    on every rank, in place; a no-op without a mesh. Returns the input."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return module_or_tensors
    from .mesh import replicate

    return replicate(mesh, module_or_tensors)


# ------------------------------------------------------------ BatchNorm


def _differentiable_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks; its backward sums the gradient over
    the ranks (``torch.distributed.nn.functional.all_reduce``, whose
    deprecation notice points at a module without autograd)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t, group=_group() or dist.group.WORLD)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode moments, within :func:`sharded`,
    are those of the global batch: per-rank sums of x and x² (in fp64) are
    summed over the ranks by the differentiable
    ``torch.distributed.nn.functional.all_reduce``, so the backward pass
    sums the moments' gradients over the ranks as well. It normalises with
    the biased variance and moves the running variance by the unbiased
    one, with the module's momentum, counting every row (the weight-0 pad
    rows too), as ``nn.BatchNorm2d`` does on the whole batch. Elsewhere
    (eval mode, one process, a batch that stays whole) it is
    ``nn.BatchNorm2d``.

    ``nn.SyncBatchNorm`` does not serve: it raises for CPU input whenever
    a process group is up, so no CPU test could run it."""

    def forward(self, x):
        if not self.training or _ROWS is None:
            return super().forward(x)
        n = _ROWS[2]
        count = n * x.shape[2] * x.shape[3]
        xd = x.to(torch.float64)
        sums = torch.cat([xd.sum(dim=(0, 2, 3)),
                          xd.square().sum(dim=(0, 2, 3))])
        sums = _differentiable_sum(sums)
        mean, sq = sums.view(2, -1) / count
        var = sq - mean.square()
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.num_batches_tracked.add_(1)
                self.running_mean.mul_(1 - m).add_(
                    m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1 - m).add_(
                    m * (var * count / max(count - 1, 1)).to(
                        self.running_var.dtype))
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        y = (x - mean.to(x.dtype)[None, :, None, None]) * inv[None, :, None,
                                                               None]
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        return y
