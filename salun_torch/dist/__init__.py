"""Distributed and selection helpers (counterpart of ``salun/dist``). Only
the exact k-th value is ported yet; the data-parallel modules follow."""

from .topk import kth_largest, kth_largest_threshold

__all__ = ["kth_largest", "kth_largest_threshold"]
