from .store import (load_mask, mask_path, save_checkpoint, save_eval_results,
                    save_mask)
from .torch_import import (ddpm_mask_from_jax, ddpm_mask_to_jax,
                           ddpm_state_dict_from_jax, load_ddpm_states,
                           load_state_dict, mask_from_jax, mask_to_jax,
                           save_ddpm_states, state_dict_from_jax)

__all__ = ["ddpm_mask_from_jax", "ddpm_mask_to_jax",
           "ddpm_state_dict_from_jax", "load_ddpm_states", "load_mask",
           "load_state_dict", "mask_from_jax", "mask_path", "mask_to_jax",
           "save_checkpoint", "save_ddpm_states", "save_eval_results",
           "save_mask", "state_dict_from_jax"]
