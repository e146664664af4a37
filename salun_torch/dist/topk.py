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
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

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
