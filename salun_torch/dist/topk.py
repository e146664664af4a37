"""Exact k-th largest value over one or many float tensors (counterpart of
``salun/dist/topk.py:63-89`` ``kth_largest``, ``kth_largest_threshold``).

The JAX package bisects on the order-preserving uint32 image of the floats
so that it can shard. On one card the same total order is one sort: each
fp32 value maps to an int32 key whose signed order is the IEEE total order
(-0.0 below +0.0, NaNs at the ends, as the uint32 image has them), the
keys are sorted, and the key of rank k maps back to the exact float. The
result is the element itself, so it equals the JAX value bitwise, ties
included. ``k`` is 1-indexed, in ``[1, N]``, and may be a tensor on the
device (no host sync).

A buffer that no rank holds whole (|θ − θ₀| under FSDP) takes JAX's form,
:func:`kth_largest_sharded`: 32 rounds of bisection over the same int32
keys, each counting the keys ≥ a candidate in this rank's pieces and
summing that count (one int64) over the ranks. The answer is the largest
key with at least k keys at or above it, which is the key of the k-th
largest element: the same float, bitwise, as the sort's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

_LOW31 = 0x7FFFFFFF


def _ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """fp32 → int32 whose signed order is the floats' total order: the
    bits of a non-negative float, the low 31 bits flipped for a negative
    one. The map is its own inverse."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _LOW31, bits)


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    return _ordered_keys(key.view(torch.float32)).view(torch.float32)


def kth_largest(flat: torch.Tensor, k: Union[int, torch.Tensor]
                ) -> torch.Tensor:
    """Exact k-th largest value (1-indexed) of a float tensor, as a 0-dim
    fp32 tensor on its device."""
    keys = _ordered_keys(flat.reshape(-1))
    n = keys.numel()
    if not isinstance(k, torch.Tensor) and not 1 <= int(k) <= n:
        raise ValueError(f"k = {k} is outside [1, {n}]")
    ascending = torch.sort(keys).values
    idx = n - (k.to(device=keys.device, dtype=torch.int64)
               if isinstance(k, torch.Tensor) else int(k))
    return _key_to_float(ascending[idx].reshape(1))[0]


def kth_largest_threshold(tensors: Sequence[torch.Tensor],
                          k: Union[int, torch.Tensor]) -> torch.Tensor:
    """Exact k-th largest value (1-indexed) across every element of
    ``tensors`` (one concatenated buffer)."""
    return kth_largest(torch.cat([t.reshape(-1).to(torch.float32)
                                  for t in tensors]), k)


def kth_largest_sharded(pieces: Sequence[torch.Tensor],
                        k: Union[int, torch.Tensor],
                        group: Optional[dist.ProcessGroup] = None
                        ) -> torch.Tensor:
    """Exact k-th largest value (1-indexed) of the buffer whose elements are
    the union over the ranks of ``group`` of each rank's ``pieces`` (every
    element held by exactly one rank; a rank may hold none). Every rank of
    ``group`` calls it and gets the same 0-dim fp32 tensor, the one
    :func:`kth_largest` gives on the whole buffer. ``k`` may be a device
    tensor (same on every rank); an int is checked against the global
    count. Without a process group the buffer is this process's pieces."""
    def sum_over_ranks(t):
        if dist.is_initialized():
            dist.all_reduce(t, group=group)

    keys = [_ordered_keys(p.reshape(-1)) for p in pieces]
    device = keys[0].device if keys else torch.device("cpu")
    if not isinstance(k, torch.Tensor):
        n = torch.tensor(sum(t.numel() for t in keys), dtype=torch.int64,
                         device=device)
        sum_over_ranks(n)
        if not 1 <= int(k) <= int(n):
            raise ValueError(f"k = {k} is outside [1, {int(n)}]")
    k = torch.as_tensor(k, dtype=torch.int64, device=device)
    lo = torch.tensor(-2 ** 31, dtype=torch.int64, device=device)
    hi = torch.tensor(2 ** 31 - 1, dtype=torch.int64, device=device)
    # [lo, hi] holds the answer and halves each round: 2^32 keys, 32 rounds
    for _ in range(32):
        mid = lo + (hi - lo + 1) // 2
        mid32 = mid.to(torch.int32)
        count = torch.zeros((), dtype=torch.int64, device=device)
        for t in keys:
            count += (t >= mid32).sum()
        sum_over_ranks(count)
        enough = count >= k
        lo = torch.where(enough, mid, lo)
        hi = torch.where(enough, hi, mid - 1)
    return _key_to_float(lo.to(torch.int32).reshape(1))[0]
