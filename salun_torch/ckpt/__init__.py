from .sd_import import (load_compvis_state_dict, load_sd_mask,
                        load_sd_modules, save_compvis, save_sd_mask,
                        sd_mask_from_jax, sd_mask_to_jax,
                        sd_state_dict_from_jax)
from .store import (checkpoint_path, load_mask, load_train_state, mask_path,
                    restore_sharded, save_checkpoint, save_eval_results,
                    save_mask, save_model, save_sharded, save_train_state)
from .torch_import import (ddpm_mask_from_jax, ddpm_mask_to_jax,
                           ddpm_state_dict_from_jax, load_ddpm_states,
                           load_ddpm_train_state, load_state_dict,
                           mask_from_jax, mask_to_jax, save_ddpm_states,
                           state_dict_from_jax)

__all__ = ["checkpoint_path", "ddpm_mask_from_jax", "ddpm_mask_to_jax",
           "ddpm_state_dict_from_jax", "load_compvis_state_dict",
           "load_ddpm_states", "load_ddpm_train_state", "load_mask",
           "load_sd_mask", "load_sd_modules", "load_state_dict",
           "load_train_state", "mask_from_jax", "mask_path", "mask_to_jax",
           "restore_sharded", "save_checkpoint", "save_compvis",
           "save_ddpm_states", "save_eval_results", "save_mask",
           "save_model", "save_sd_mask", "save_sharded", "save_train_state",
           "sd_mask_from_jax", "sd_mask_to_jax", "sd_state_dict_from_jax",
           "state_dict_from_jax"]
