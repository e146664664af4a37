"""Unlearning-method registry (counterpart of
``salun/core/methods/__init__.py``; reference
Classification/unlearn/__init__.py:22-61).

Ported: ``RL`` and ``raw``. The other 15 names of the reference registry
are listed and raise ``NotImplementedError`` until they are ported.
"""

from .common import (UnlearnConfig, make_unlearn_optimizer, mask_tensors,
                     snapshot_params)
from .iterative import RL, raw

_METHODS = {"raw": raw, "RL": RL}

NOT_PORTED = (
    "GA", "GA_l1", "FT", "FT_l1", "fisher", "fisher_new", "retrain",
    "wfisher", "FT_prune", "FT_prune_bi", "GA_prune", "GA_prune_bi",
    "boundary_expanding", "boundary_shrink", "RL_proximal",
)


def get_unlearn_method(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"unlearn method {name} is not ported yet")
    if name not in _METHODS:
        raise NotImplementedError(
            f"Unlearn method {name} not implemented! Available: "
            f"{sorted(_METHODS)}")
    return _METHODS[name]


__all__ = ["NOT_PORTED", "RL", "UnlearnConfig", "get_unlearn_method",
           "make_unlearn_optimizer", "mask_tensors", "raw", "snapshot_params"]
