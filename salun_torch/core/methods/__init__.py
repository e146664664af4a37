"""Unlearning-method registry (counterpart of
``salun/core/methods/__init__.py``; reference
Classification/unlearn/__init__.py:22-61).

Ported: ``raw``, ``RL``, ``GA``, ``GA_l1``, ``FT``, ``FT_l1`` and
``retrain``. The other ten names of the reference registry are listed and
raise ``NotImplementedError`` until they are ported.
"""

from .common import (UnlearnConfig, make_unlearn_optimizer, mask_tensors,
                     snapshot_params)
from .iterative import FT, FT_l1, GA, GA_l1, RL, l1_schedule, raw, retrain

_METHODS = {"raw": raw, "RL": RL, "GA": GA, "GA_l1": GA_l1, "FT": FT,
            "FT_l1": FT_l1, "retrain": retrain}

NOT_PORTED = (
    "fisher", "fisher_new", "wfisher", "FT_prune", "FT_prune_bi", "GA_prune",
    "GA_prune_bi", "boundary_expanding", "boundary_shrink", "RL_proximal",
)


def get_unlearn_method(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"unlearn method {name} is not ported yet")
    if name not in _METHODS:
        raise NotImplementedError(
            f"Unlearn method {name} not implemented! Available: "
            f"{sorted(_METHODS)}")
    return _METHODS[name]


__all__ = ["FT", "FT_l1", "GA", "GA_l1", "NOT_PORTED", "RL", "UnlearnConfig",
           "get_unlearn_method", "l1_schedule", "make_unlearn_optimizer",
           "mask_tensors", "raw", "retrain", "snapshot_params"]
