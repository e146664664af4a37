from .mask import (DEFAULT_THRESHOLDS, accumulate_saliency, generate_masks,
                   global_topk_masks, threshold_mask)
from .masked_opt import SGD, FlatParams, GradMaskSGD, MaskedSGD

__all__ = ["DEFAULT_THRESHOLDS", "FlatParams", "GradMaskSGD", "MaskedSGD",
           "SGD", "accumulate_saliency", "generate_masks", "global_topk_masks",
           "threshold_mask"]
