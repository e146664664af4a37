from .sd_import import (load_compvis_state_dict, load_sd_mask,
                        load_sd_modules, save_compvis, save_sd_mask,
                        sd_mask_from_jax, sd_mask_to_jax,
                        sd_state_dict_from_jax)
from .store import (load_mask, mask_path, save_checkpoint, save_eval_results,
                    save_mask)
from .torch_import import (ddpm_mask_from_jax, ddpm_mask_to_jax,
                           ddpm_state_dict_from_jax, load_ddpm_states,
                           load_state_dict, mask_from_jax, mask_to_jax,
                           save_ddpm_states, state_dict_from_jax)

__all__ = ["ddpm_mask_from_jax", "ddpm_mask_to_jax",
           "ddpm_state_dict_from_jax", "load_compvis_state_dict",
           "load_ddpm_states", "load_mask", "load_sd_mask",
           "load_sd_modules", "load_state_dict", "mask_from_jax",
           "mask_path", "mask_to_jax", "save_checkpoint", "save_compvis",
           "save_ddpm_states", "save_eval_results", "save_mask",
           "save_sd_mask", "sd_mask_from_jax", "sd_mask_to_jax",
           "sd_state_dict_from_jax", "state_dict_from_jax"]
