"""Unlearning-method registry (counterpart of
``salun/core/methods/__init__.py``; reference
Classification/unlearn/__init__.py:22-61): the same 17 names plus ``raw``.

Every method is ``method(loaders, model, cfg, mask=None, *, device,
source=None, ...) -> (model, optimizer or None)`` and updates ``model`` in
place, except ``boundary_expanding``, which returns the widened model.
"""

from .boundary import boundary_expanding, boundary_shrink
from .common import (UnlearnConfig, make_unlearn_optimizer, mask_tensors,
                     reset_optimizer, snapshot_params)
from .fisher import fisher, fisher_new
from .iterative import FT, FT_l1, GA, GA_l1, RL, l1_schedule, raw, retrain
from .prune_variants import FT_prune, FT_prune_bi, GA_prune, GA_prune_bi
from .rl_proximal import RL_proximal
from .wfisher import Wfisher

_METHODS = {
    "raw": raw,
    "RL": RL,
    "GA": GA,
    "GA_l1": GA_l1,
    "FT": FT,
    "FT_l1": FT_l1,
    "fisher": fisher,
    "fisher_new": fisher_new,
    "retrain": retrain,
    "wfisher": Wfisher,
    "FT_prune": FT_prune,
    "FT_prune_bi": FT_prune_bi,
    "GA_prune": GA_prune,
    "GA_prune_bi": GA_prune_bi,
    "boundary_expanding": boundary_expanding,
    "boundary_shrink": boundary_shrink,
    "RL_proximal": RL_proximal,
}


def get_unlearn_method(name: str):
    if name not in _METHODS:
        raise NotImplementedError(
            f"Unlearn method {name} not implemented! Available: "
            f"{sorted(_METHODS)}")
    return _METHODS[name]


__all__ = ["FT", "FT_l1", "FT_prune", "FT_prune_bi", "GA", "GA_l1",
           "GA_prune", "GA_prune_bi", "RL", "RL_proximal", "UnlearnConfig",
           "Wfisher", "boundary_expanding", "boundary_shrink", "fisher",
           "fisher_new", "get_unlearn_method", "l1_schedule",
           "make_unlearn_optimizer", "mask_tensors", "raw",
           "reset_optimizer", "retrain", "snapshot_params"]
