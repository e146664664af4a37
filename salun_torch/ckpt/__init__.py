from .store import (load_mask, mask_path, save_checkpoint, save_eval_results,
                    save_mask)
from .torch_import import (load_state_dict, mask_from_jax, mask_to_jax,
                           state_dict_from_jax)

__all__ = ["load_mask", "load_state_dict", "mask_from_jax", "mask_path",
           "mask_to_jax", "save_checkpoint", "save_eval_results", "save_mask",
           "state_dict_from_jax"]
